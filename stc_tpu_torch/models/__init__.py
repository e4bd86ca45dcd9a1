"""models of stc_tpu_torch."""
