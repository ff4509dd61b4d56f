"""rwkv6-1.6b "Finch" [arXiv:2404.05892]: attention-free RWKV6 with
data-dependent decay; head size 64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", rwkv=True,
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
)
