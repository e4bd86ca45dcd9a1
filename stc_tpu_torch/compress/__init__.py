"""compress of stc_tpu_torch."""
