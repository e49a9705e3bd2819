"""The reference's pieces against values worked out by hand."""

import math

import pytest
import torch

from perfbench import reference as ref
from perfbench import weights


def close(a, b, tol=1e-6):
    return torch.allclose(torch.as_tensor(a, dtype=torch.float32),
                          torch.as_tensor(b, dtype=torch.float32), atol=tol)


def test_rms_norm():
    x = torch.tensor([3.0, 4.0])
    got = ref.norm(x, {"scale": torch.tensor([1.0, 2.0])}, "rms", 0.0)
    r = math.sqrt((9 + 16) / 2)
    assert close(got, [3 / r, 8 / r])


def test_layer_norm():
    x = torch.tensor([1.0, 3.0])
    got = ref.norm(x, {"scale": torch.ones(2), "bias": torch.full((2,), .5)},
                   "ln", 0.0)
    assert close(got, [-0.5, 1.5])


def test_partial_rope_turns_the_first_pair_only():
    x = torch.tensor([[[1.0, 0.0, 5.0, 6.0]]])          # [T=1, H=1, hd=4]
    got = ref.rope(x, torch.tensor([1]), 10_000.0, 0.5)
    assert close(got[0, 0], [math.cos(1), math.sin(1), 5.0, 6.0])


def test_rope_frequencies_fall_along_the_pairs():
    x = torch.tensor([[[1.0, 0.0, 1.0, 0.0]]])
    got = ref.rope(x, torch.tensor([2]), 100.0, 1.0)
    # pair 0 turns by 2 rad, pair 1 by 2 · 100^(-1/2) = 0.2 rad
    assert close(got[0, 0], [math.cos(2), math.sin(2), math.cos(.2),
                             math.sin(.2)])


def _eye_attention(window=None):
    conf = {"n_heads": 1, "n_kv_heads": 1, "head_dim": 2, "qkv_bias": False,
            "rope_theta": 1e4, "rotary_pct": 0.0, "window": window}
    p = {k: torch.eye(2) for k in ("wq", "wk", "wv", "wo")}
    return conf, p


def test_causal_attention_by_hand():
    conf, p = _eye_attention()
    h = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    got = ref.attention(conf, p, h, "f32")
    e = math.exp(1 / math.sqrt(2))
    assert close(got, [[1.0, 0.0], [1 / (1 + e), e / (1 + e)]])


def test_window_hides_older_keys():
    conf, p = _eye_attention(window=1)
    h = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    assert close(ref.attention(conf, p, h, "f32"), h)


def test_query_blocks_do_not_change_the_result(monkeypatch):
    conf, p = _eye_attention(window=3)
    conf = dict(conf, rotary_pct=1.0)
    h = torch.randn(7, 2, generator=torch.Generator().manual_seed(0))
    whole = ref.attention(conf, p, h, "f32")
    monkeypatch.setattr(ref, "Q_BLOCK", 2)
    assert close(ref.attention(conf, p, h, "f32"), whole)


def _moe_conf(top_k, factor):
    return {"moe": {"num_experts": 2, "top_k": top_k, "expert_d_ff": 1,
                    "capacity_factor": factor}}


def test_moe_drops_pairs_past_capacity():
    # every token prefers expert 0; 4 tokens, top-1, capacity ceil(4/2) = 2
    p = {"router": torch.tensor([[1.0, -1.0]]),
         "wi": torch.ones(2, 1, 1), "wg": torch.ones(2, 1, 1),
         "wo": torch.ones(2, 1, 1)}
    h = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    got = ref.moe(_moe_conf(1, 1.0), p, h, "f32")
    silu = lambda x: x / (1 + math.exp(-x))
    assert close(got[:, 0], [silu(1) * 1, silu(2) * 2, 0.0, 0.0])


def test_moe_ties_go_to_the_lower_expert_and_gates_renormalize():
    p = {"router": torch.zeros(1, 2), "wi": torch.ones(2, 1, 1),
         "wg": torch.ones(2, 1, 1),
         "wo": torch.tensor([[[1.0]], [[10.0]]])}
    h = torch.tensor([[1.0]])
    silu1 = 1 / (1 + math.exp(-1))
    assert close(ref.moe(_moe_conf(1, 4.0), p, h, "f32")[0, 0], silu1)
    # top-2 of two equal experts: gates 1/2 each
    assert close(ref.moe(_moe_conf(2, 4.0), p, h, "f32")[0, 0],
                 0.5 * silu1 + 0.5 * 10 * silu1)


def test_topk_keeps_the_largest_magnitudes_ties_to_the_lower_index():
    idx, k = ref.topk_keep(torch.tensor([1.0, -3.0, 2.0, -3.0]), 0.5)
    assert k == 2 and idx.tolist() == [1, 3]


def test_error_feedback_carries_what_was_not_shipped():
    idx, vals, left = ref.error_feedback(
        torch.tensor([1.0, -3.0, 2.0, -3.0]),
        torch.tensor([0.5, 0.0, 0.0, 2.5]), 0.5)
    # carried [1.5, -3, 2, -0.5]: ships -3 and 2
    assert idx.tolist() == [1, 2] and vals.tolist() == [-3.0, 2.0]
    assert left.tolist() == [1.5, 0.0, 0.0, -0.5]


def test_dot_sum():
    got = ref.dot_sum(torch.ones(3), [(torch.tensor([0]), torch.tensor([2.])),
                                      (torch.tensor([0, 2]),
                                       torch.tensor([1., 4.]))], 0.5)
    assert close(got, [2.5, 1.0, 3.0])


OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "clip_norm": 1.0, "warmup_steps": 5, "total_steps": 105,
       "min_lr_frac": 0.1}


def test_learning_rate_schedule():
    assert ref.lr_at(OPT, 1) == pytest.approx(2e-4)
    assert ref.lr_at(OPT, 5) == pytest.approx(1e-3)
    assert ref.lr_at(OPT, 55) == pytest.approx(1e-4 + 9e-4 * 0.5)
    assert ref.lr_at(OPT, 105) == pytest.approx(1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[448.0, 1.0, 1.0625, 1.25]])
    got = ref.fake_fp8(x, -1)
    assert got.tolist() == [[448.0, 1.0, 1.0, 1.25]]


TINY = {"name": "t", "n_layers": 1, "d_model": 8, "n_heads": 2,
        "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 11,
        "qkv_bias": True, "rotary_pct": 0.5, "rope_theta": 1e4,
        "act": "swiglu", "norm": "ln", "norm_eps": 1e-6, "pos": "rope",
        "tie_embeddings": False, "window": None, "mlp": "dense",
        "dtype": "float32"}


def test_first_adamw_step_moves_each_weight_by_the_learning_rate():
    """Step 1 of AdamW: m̂ = g, v̂ = g², so each weight moves by
    lr · (g / (|g| + eps) + wd · w)."""
    tok = torch.tensor([[1, 2, 3, 4, 5]])
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    got = ref.train_steps(TINY, 7, [batch], OPT)
    params = {p: weights.initial_leaf(TINY, 7, p, "cpu").requires_grad_(True)
              for p in weights.leaf_paths(TINY)}
    loss = ref.row_loss(TINY, params, batch["tokens"][0], batch["labels"][0])
    loss.backward()
    gnorm = math.sqrt(sum(float((t.grad ** 2).sum()) for t in params.values()))
    scale = min(1.0, 1.0 / (gnorm + 1e-9))
    lr = ref.lr_at(OPT, 1)
    assert got["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-6)
    for p, t in params.items():
        g = t.grad * scale
        want = lr * (g / (g.abs() + OPT["eps"])
                     + OPT["weight_decay"] * t.detach())
        assert got["grad_norms"][p] == pytest.approx(float(g.norm()),
                                                     rel=1e-5)
        assert got["update_norms"][p] == pytest.approx(float(want.norm()),
                                                       rel=1e-4)


def test_serve_logits_match_the_training_forward():
    tok = torch.tensor([[1, 2, 3, 4, 5, 6]])
    logits = ref.serve_logits(TINY, 3, tok, 4)                # pos 3..5
    params = {p: weights.initial_leaf(TINY, 3, p, "cpu")
              for p in weights.leaf_paths(TINY)}
    # a longer served tail gives the same logits where both have them,
    # and their cross-entropy is the training forward's loss
    full = ref.serve_logits(TINY, 3, tok, 1)                  # pos 0..5
    assert close(full[:, 3:], logits, 1e-5)
    labels = torch.tensor([2, 3, 4, 5, 6, 7])
    ce = torch.nn.functional.cross_entropy(full[0], labels)
    assert float(ce) == pytest.approx(
        float(ref.row_loss(TINY, params, tok[0], labels)), rel=1e-5)
