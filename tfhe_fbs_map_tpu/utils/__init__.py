from .cache import enable_compile_cache
from .profiling import jax_trace

__all__ = ["enable_compile_cache", "jax_trace"]
