"""stc_tpu_torch: the PyTorch/CUDA port of stc_tpu.

Streaming-video LLM acceleration (STC-Cacher + STC-Pruner + ReKV retrieval
KV cache) in PyTorch, with hand-written CUDA kernels for Hopper where the
JAX package has Pallas kernels.  It imports nothing of the JAX package.
"""
