"""zamba2-1.2b [arXiv:2411.15242]: Mamba2 backbone + one shared-weight
attention block (invoked every 6th layer) with per-invocation LoRA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, shared_attn_every=6,
)
