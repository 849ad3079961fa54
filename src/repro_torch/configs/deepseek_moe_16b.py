"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6,
first layer dense-FFN. [arXiv:2401.06066]

A copy of ``repro.configs.deepseek_moe_16b`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mlp import MLPConfig, MoEConfig


def _cfg(n_layers, d, heads, kv, dh, d_expert, vocab, n_routed, top_k,
         n_shared, first_ff):
    return LMConfig(
        name="deepseek-moe-16b",
        n_layers=n_layers,
        d_model=d,
        vocab_size=vocab,
        ffn_pattern=("moe",),
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=dh,
                        rope_theta=10000.0),
        moe=MoEConfig(d_model=d, d_expert=d_expert, n_routed=n_routed,
                      n_shared=n_shared, top_k=top_k, act="silu",
                      router_scale_norm=False),
        first_dense_layers=1,
        first_dense_mlp=MLPConfig(d_model=d, d_ff=first_ff, act="silu"),
    )


SPEC = ArchSpec(
    arch_id="deepseek-moe-16b",
    family="lm",
    config=_cfg(28, 2048, 16, 16, 128, 1408, 102400, 64, 6, 2, 10944),
    smoke=_cfg(2, 64, 4, 4, 16, 48, 512, 8, 2, 1, 128),
)
