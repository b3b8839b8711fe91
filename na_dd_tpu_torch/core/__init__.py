"""core (port of na_dd_tpu.core)."""
