"""deepseek-7b [dense] — llama-arch MHA. [arXiv:2401.02954]

A copy of ``repro.configs.deepseek_7b`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mlp import MLPConfig


def _cfg(n_layers, d, heads, kv, dh, ff, vocab):
    return LMConfig(
        name="deepseek-7b",
        n_layers=n_layers,
        d_model=d,
        vocab_size=vocab,
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=dh,
                        rope_theta=10000.0),
        mlp=MLPConfig(d_model=d, d_ff=ff, act="silu"),
    )


SPEC = ArchSpec(
    arch_id="deepseek-7b",
    family="lm",
    config=_cfg(30, 4096, 32, 32, 128, 11008, 102400),
    smoke=_cfg(2, 64, 4, 4, 16, 160, 512),
)
