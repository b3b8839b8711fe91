"""mms (port of na_dd_tpu.mms)."""
