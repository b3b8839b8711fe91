"""ops (port of na_dd_tpu.ops)."""
