"""whisper-tiny [arXiv:2212.04356]: encoder-decoder; conv frontend is a
stub (input_specs provides precomputed 1500-frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500, encoder_d_ff=1536,
    frontend_stub=True, tie_embeddings=True,
)
