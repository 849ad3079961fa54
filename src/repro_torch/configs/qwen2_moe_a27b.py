"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 (padded to 64 for EP
divisibility on the 16-way model axis; pad experts are router-masked).
[hf:Qwen/Qwen1.5-MoE-A2.7B]

A copy of ``repro.configs.qwen2_moe_a27b`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.mlp import MoEConfig


def _cfg(n_layers, d, heads, kv, dh, d_expert, vocab, n_routed, top_k,
         n_shared, n_padded):
    return LMConfig(
        name="qwen2-moe-a2.7b",
        n_layers=n_layers,
        d_model=d,
        vocab_size=vocab,
        ffn_pattern=("moe",),
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=dh,
                        rope_theta=1_000_000.0, qkv_bias=True),
        moe=MoEConfig(d_model=d, d_expert=d_expert, n_routed=n_routed,
                      n_shared=n_shared, top_k=top_k, act="silu",
                      n_routed_padded=n_padded, router_scale_norm=False),
    )


SPEC = ArchSpec(
    arch_id="qwen2-moe-a2.7b",
    family="lm",
    config=_cfg(24, 2048, 16, 16, 128, 1408, 151936, 60, 4, 4, 64),
    smoke=_cfg(2, 64, 4, 4, 16, 48, 512, 6, 2, 1, 8),
)
