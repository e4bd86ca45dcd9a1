"""utils of stc_tpu_torch."""
