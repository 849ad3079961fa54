"""granite-3-2b [dense] — GQA kv=8, tied embeddings. [hf:ibm-granite/granite-3.0-2b-base]

A copy of ``repro.configs.granite_3_2b`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mlp import MLPConfig


def _cfg(n_layers, d, heads, kv, dh, ff, vocab):
    return LMConfig(
        name="granite-3-2b",
        n_layers=n_layers,
        d_model=d,
        vocab_size=vocab,
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=dh,
                        rope_theta=10000.0),
        mlp=MLPConfig(d_model=d, d_ff=ff, act="silu"),
        tie_embeddings=True,
        vocab_pad_to=256,
    )


SPEC = ArchSpec(
    arch_id="granite-3-2b",
    family="lm",
    config=_cfg(40, 2048, 32, 8, 64, 8192, 49155),
    smoke=_cfg(2, 64, 4, 2, 16, 160, 512),
)
