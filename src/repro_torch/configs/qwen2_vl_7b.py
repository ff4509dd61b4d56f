"""qwen2-vl-7b [arXiv:2409.12191]: dense backbone with M-RoPE (temporal/
height/width sections); vision frontend is a stub (input_specs provides
patch embeddings / position ids)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
)
