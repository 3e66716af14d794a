"""whisper-small [audio] — encoder-decoder, conv frontend (STUB).

12L (decoder; +12 encoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
[arXiv:2212.04356; unverified]. Per the assignment the conv audio frontend is a stub:
``input_specs()`` supplies precomputed (batch, 1500, d_model) frame embeddings.
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    attn_pattern=(GLOBAL_ATTN,),
    mlp="gelu",
    is_encoder_decoder=True,
    n_enc_layers=12,
    n_enc_positions=1500,
    frontend="audio_frames",
    tie_embeddings=True,
    rope_theta=0.0,     # whisper uses learned/sinusoidal positions, not RoPE
)
