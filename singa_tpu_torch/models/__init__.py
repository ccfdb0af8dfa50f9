from .generate import forward_cached, generate, init_cache
from .transformer import synthetic_token_batches, transformer_lm
