"""runtime of stc_tpu_torch."""
