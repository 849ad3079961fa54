"""qwen2-72b [dense] — GQA kv=8, QKV bias. [arXiv:2407.10671]

A copy of ``repro.configs.qwen2_72b`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mlp import MLPConfig


def _cfg(n_layers, d, heads, kv, dh, ff, vocab):
    return LMConfig(
        name="qwen2-72b",
        n_layers=n_layers,
        d_model=d,
        vocab_size=vocab,
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=dh,
                        rope_theta=1_000_000.0, qkv_bias=True),
        mlp=MLPConfig(d_model=d, d_ff=ff, act="silu"),
    )


SPEC = ArchSpec(
    arch_id="qwen2-72b",
    family="lm",
    config=_cfg(80, 8192, 64, 8, 128, 29568, 152064),
    smoke=_cfg(2, 64, 4, 2, 16, 192, 512),
)
