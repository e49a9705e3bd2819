#!/usr/bin/env python3
"""Where the flash kernels' time goes, on one NVIDIA card. Run from the
root of a checkout, after ``chip_smoke.py`` passes:

    python3 flash_probe.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` and copies of it
with one phase taken out (an exact text substitution each; a substitution
that no longer matches the source fails the run), all with ``nvcc`` at
once into ``build/probe/``, then times each copy's kernel at the served
bf16 shapes of ``chip_smoke.py`` — prefill qwen1.5-0.5b and qwen2-1.5b,
decode against their caches — as device time (``chip_smoke.time_ms``
with the card held busy while the host enqueues). Only the full kernel's
output is checked (its error against the plain version is printed); the
copies compute wrong results on purpose, and their time is an upper bound
on what the phase they lack costs. Prints one line per shape, the time
of a one-element kernel (the floor of this timing), and the full decode
kernel with one and with four threads a slot on three caches.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "flash_attention.cu"
OUT = ROOT / "build" / "probe"

PREFILL_LOADS = "    if (t + 2 < t_end) load_kv(t + 2);\n"
PV_LO = "      wgmma_rs<T, HD>(acc, pl[kk], dv);\n"
PV_HI = "      wgmma_rs<T, HD>(acc, ph[kk], dv);\n"
INSIDE = ("const bool inside = k0 + kTcBK - 1 <= wg_row0 && k0 + kTcBK <= "
          "SK &&\n                      wg_row0 + 63 - k0 < opt.window;")
EXP = ("    s[i] = ex2(s[i] - m[(i >> 1) & 1]);",
       "    s[i] = s[i] - m[(i >> 1) & 1];")
ALPHA = ("    alpha[h] = ex2(m[h] - m_new);", "    alpha[h] = 1.f;")
DEC_END = "  cp_async_wait<0>();   // no copy outlives the loop (empty groups)"
DEC_SCORES = ("for (int g0 = 0; g0 < G; g0 += NH) {\n      float dots[NH];",
              "for (int g0 = 0; g0 < 0; g0 += NH) {\n      float dots[NH];")
DEC_PROBS = ("for (int g = 0; g < G; ++g) {\n      float mx = m_old[g];",
             "for (int g = 0; g < 0; ++g) {\n      float mx = m_old[g];")
DEC_PV = ("if (sub < nsub) {", "if (sub < 0) {")
DEC_LOADS = (("if (i < ntiles) stage(i);", "if (i < 0) stage(i);"),
             ("if (it + stages - 1 < ntiles) stage(it + stages - 1);", ""))

# name: (what it takes out, substitutions)
VARIANTS = {
    "full": ("nothing", []),
    "prefill-no-lo": ("the lo half of P: its split and its P V product",
                      [(PV_LO, "")]),
    "prefill-no-pv": ("both P V products", [(PV_LO, ""), (PV_HI, "")]),
    "prefill-no-mask": ("the masks (every tile taken as inside the band)",
                        [(INSIDE, "const bool inside = true;")]),
    "prefill-no-exp": ("the exp2 of P and of the rescale", [EXP, ALPHA]),
    "prefill-no-loads": ("the K and V copies after the first two tiles",
                         [(PREFILL_LOADS, "")]),
    "decode-no-merge": ("the last block's merge",
                        [("  if (!*last_sh) return;", "  return;")]),
    "decode-no-partials": ("partials, counter and merge",
                           [(DEC_END, "  cp_async_wait<0>();\n  return;")]),
    "decode-no-compute": ("scores, softmax, P V and all after the loop",
                          [DEC_SCORES, DEC_PROBS, DEC_PV,
                           (DEC_END, "  cp_async_wait<0>();\n  return;")]),
    "decode-no-loads": ("the K, V and position copies too",
                        [DEC_SCORES, DEC_PROBS, DEC_PV, *DEC_LOADS,
                         (DEC_END, "  cp_async_wait<0>();\n  return;")]),
}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise AssertionError(f"probe substitution no longer matches the "
                                 f"source: {old!r}")
        text = text.replace(old, new)
    return text


def build_all() -> dict:
    """Every variant compiled at once; returns name -> loaded library."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(text, subs))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{report}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def prefill_call(lib, q, k, v, o):
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, h, s, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            k.shape[1], s, s, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], float(hd) ** -0.5,
            fa.NO_WINDOW, 0.0, fa.VALUE_DTYPES[q.dtype])

    def call():
        rc = lib.rt_flash_attention_tc(
            *args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def decode_call(lib, q, k, v, qpos, kpos, o, tps=None):
    """The decode launch of the wrapper's tile, split and threads-per-slot
    rules (``tps`` overrides the last)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, h, _, hd = q.shape
    kv, C = k.shape[1], k.shape[2]
    tile = fa.decode_tile(hd, q.element_size())
    sms = fa.sm_count(q.device)
    splits, per = fa.decode_splits(b, kv, C, tile, sms)
    if tps is None:
        tps = fa.decode_threads_per_slot(h // kv, hd, splits * kv * b, sms)
    n = b * h * splits
    part = torch.empty(-(-n * hd // 4) * 4 + 2 * n, dtype=torch.float32,
                       device=q.device)
    counters = torch.zeros(b * kv, dtype=torch.int32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), o.data_ptr(), part.data_ptr(),
            counters.data_ptr(), b, h, kv, C, hd, splits, per, tile, tps, 1,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            qpos.stride(0), *kpos.stride(), *o.stride()[:2],
            float(hd) ** -0.5, fa.NO_WINDOW, 0.0, fa.VALUE_DTYPES[q.dtype])

    def call():
        rc = lib.rt_flash_decode(*args,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    libs = build_all()
    for name, (what, _) in VARIANTS.items():
        print(f"{name}: takes out {what}")
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    floor = cs.time_ms(lambda: one.add_(1), held=True)
    print(f"one-element kernel: {floor:.5f} ms (the floor of this timing)")
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for tag, b, h, kv, s, hd, _, _ in cs.PREFILL_CHECKS[:2]:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, h, s, hd), (b, kv, s, hd),
                                 (b, kv, s, hd)))
        o = torch.empty_like(q)
        row = []
        for name, lib in libs.items():
            if name.startswith("decode"):
                continue
            call = prefill_call(lib, q, k, v, o)
            call()
            if name == "full":
                torch.cuda.synchronize()
                err = float((o.float() - ref.attention_ref(
                    q, k, v).float()).abs().max())
                row.append(f"max_abs_err={err:.3g}")
            row.append(f"{name}={cs.time_ms(call, held=True):.5f}")
        print(f"prefill {tag} bf16 device ms: " + " ".join(row), flush=True)
    for tag, b, h, kv, C, hd, filled, _, _, _ in cs.DECODE_CHECKS[:2]:
        k, v, kpos = cs._ring(b, kv, C, hd, filled, dtype, dev, gen)
        q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(dtype)
        qpos = torch.full((b, 1), filled, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)
        row = []
        for name, lib in libs.items():
            if name.startswith("prefill"):
                continue
            call = decode_call(lib, q, k, v, qpos, kpos, o)
            call()
            if name == "full":
                torch.cuda.synchronize()
                err = float((o.float() - ref.decode_ref(
                    q, k, v, qpos, kpos).float()).abs().max())
                row.append(f"max_abs_err={err:.3g}")
            row.append(f"{name}={cs.time_ms(call, held=True):.5f}")
        print(f"decode {tag} bf16 device ms: " + " ".join(row), flush=True)
    # the decode's threads per slot, both ways, on its served qwen2 cache
    # and on two 512-block grids of long dots
    from repro_torch.kernels import flash_attention as fa
    for tag, b, h, kv, C, hd, filled in (
            ("qwen2-1.5b", 2, 12, 2, 1016, 128, 1008),
            ("b2-h48-kv8-hd128", 2, 48, 8, 4096, 128, 4000),
            ("b1-h64-kv8-hd128", 1, 64, 8, 8192, 128, 8000)):
        k, v, kpos = cs._ring(b, kv, C, hd, filled, dtype, dev, gen)
        q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(dtype)
        qpos = torch.full((b, 1), filled, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)
        sms = fa.sm_count(q.device)
        splits, _ = fa.decode_splits(b, kv, C, fa.decode_tile(hd, 2), sms)
        blocks = splits * kv * b
        row = [f"blocks={blocks} rule="
               f"{fa.decode_threads_per_slot(h // kv, hd, blocks, sms)}"]
        for tps in (1, 4):
            call = decode_call(libs["full"], q, k, v, qpos, kpos, o, tps)
            call()
            row.append(f"tps{tps}={cs.time_ms(call, held=True):.5f}")
        print(f"decode threads per slot {tag} bf16 device ms: "
              + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
