"""stablelm-12b [hf:stabilityai/stablelm-2-12b]: dense GQA with partial
rotary (25%) and per-head qk layernorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    rope_pct=0.25, qk_norm=True, rope_theta=10_000.0,
)
