"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8 with
normalised top-k routing, GQA kv=4, head_dim 128, per-head qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=6144, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_d_ff=768, norm_topk=True,
    qk_norm=True, rope_theta=1_000_000.0,
)
