from .attention import (attention_reference, expand_kv_heads,
                        flash_attention, flash_attention_packed,
                        flash_attention_packed_lse, rope, rope_packed)
from .head_loss import fused_lm_xent, head_stats
from .loss import (chunked_lm_xent, softmax_cross_entropy,
                   softmax_loss_metrics, topk_precision)
