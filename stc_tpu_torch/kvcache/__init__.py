"""kvcache of stc_tpu_torch."""
