"""models (port of na_dd_tpu.models)."""
