"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

Arctic's dense-MoE hybrid: a dense FFN residual runs in parallel with the
128-expert top-2 MoE in every layer.  At 480B parameters this is the memory
heavyweight of the pool: params/grads in bf16 and blockwise-int8 AdamW
moments are required to fit train_4k on a single 256-chip v5e pod
(DESIGN.md §2; the fp32 variant exceeds 16 GB/chip).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    param_dtype="bfloat16",
    opt_dtype="int8",
    microbatch=16,
    # 468B of expert weights cannot live model-sharded only: shard the
    # expert ff dim over the data axis too (ZeRO-3 style; gathered per layer)
    sharding_overrides=(("expert_mlp", "data"),),
    source="hf:Snowflake/snowflake-arctic-base",
    notes="dense-MoE hybrid; 56 heads do not divide a 16-way model axis "
          "(GSPMD pads; see DOS imbalance notes)",
))
