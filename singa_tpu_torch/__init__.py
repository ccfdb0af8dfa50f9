"""singa_tpu_torch: the PyTorch and CUDA port of singa_tpu.

The JAX package `singa_tpu` is the reference; this package grows beside
it slice by slice and imports nothing of it (nor JAX).  Slice 1 is
transformer-LM inference: the scoring forward (`NeuralNet.apply`), KV
cache decode (`models.generate`) and the bucketed engine
(`serve.engine`), with two hand-written Hopper kernels built from
`csrc/` at first use: the packed flash-attention forward (K1,
`ops.attention`) and the fused LM-head forward (K2, `ops.head_loss`).

Slice 2 trains the LM: K3 and K4 (the flash backward), the updaters,
the `Trainer` and checkpoints.  Slice 3 is the vision zoo
(`core.layers`, `models.vision`) with AlexNet-CIFAR10 training, and K5
and K6, the cross-channel LRN forward and backward (`ops.lrn`).

Serving (`serve`) runs the bucketed engine as one CUDA graph per
(mode, bucket) and continuous batching (`serve.ContinuousScheduler`)
over a paged KV cache, its prefill and decode step captured as two
graphs.

`examples/transformer/lm.conf`, the repo's flagship LM config, runs
whole: kMoE (`ops.moe`) with its router aux loss in training, replayed
or eager, `models.generate.beam_search`, and serving a MoE net.

Entry points run on CUDA unless the caller passes device='cpu'.
"""

from .config import (ConfigError, ModelConfig, config_to_dict,
                     load_model_config, model_config_from_dict,
                     model_config_from_text)
from .core.net import NeuralNet, build_net
from .core.trainer import Trainer
from .core.updater import Multipliers, Updater, learning_rate
from .data import synthetic_image_batches
from .device import resolve_device
from .models.generate import (beam_search, forward_cached, generate,
                              init_cache)
from .models.transformer import synthetic_token_batches, transformer_lm
from .models.vision import (alexnet_cifar10, alexnet_cifar10_full,
                            alexnet_imagenet, lenet_mnist, mlp_mnist)
from .serve.engine import InferenceEngine, ServeSpec
from .utils.checkpoint import CheckpointManager
from .weights import (numpy_params, opt_state_from_numpy, params_from_numpy,
                      state_to_numpy)
