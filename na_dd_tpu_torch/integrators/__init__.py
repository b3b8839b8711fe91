"""integrators (port of na_dd_tpu.integrators)."""
