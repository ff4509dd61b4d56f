"""minicpm-2b [arXiv:2404.06395]: llama-like dense with muP-style scaling
(depth-scaled residuals, scaled embeddings/logits) trained under WSD."""
import math
from repro_torch.models.config import ModelConfig

_L, _D = 40, 2304
CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=_L, d_model=_D, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    residual_scale=1.4 / math.sqrt(_L),    # depth scaling (paper §4)
    embed_scale=12.0, logit_scale=1.0 / (_D / 256),
    tie_embeddings=True, rope_theta=10_000.0,
    # WSD learning-rate schedule is configured in optim (schedule="wsd")
)
