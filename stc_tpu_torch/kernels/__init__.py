"""kernels of stc_tpu_torch."""
