"""Turn on the persistent JAX compilation cache for a script
(alvrl_tpu.compile_cache decides the directory)."""
from alvrl_tpu import compile_cache

compile_cache.enable()
