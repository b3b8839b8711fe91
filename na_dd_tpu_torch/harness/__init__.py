"""harness (port of na_dd_tpu.harness)."""
