"""llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E]: MoE 16
experts top-1 + shared expert; iRoPE: chunked-local attention (8192) with
a global NoPE layer every 4th layer.  Early-fusion vision path is out of
scope (text backbone per assignment)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, moe_d_ff=8192, shared_expert=True,
    chunk_size=8192, global_every=4, rope_theta=500_000.0,
)
