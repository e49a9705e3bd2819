"""Drivers, one per kind of traffic; a mix's ``driver`` key names one."""
