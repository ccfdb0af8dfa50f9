from .generate import beam_search, forward_cached, generate, init_cache
from .transformer import synthetic_token_batches, transformer_lm
from .vision import (alexnet_cifar10, alexnet_cifar10_full, alexnet_imagenet,
                     lenet_mnist, mlp_mnist)
