"""h2o-danube-1.8b [arXiv:2401.16818]: llama+mistral mix with sliding-
window attention (the released 1.8b uses a 4096 local window)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0,
)
