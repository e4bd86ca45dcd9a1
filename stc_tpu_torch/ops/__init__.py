"""ops of stc_tpu_torch."""
