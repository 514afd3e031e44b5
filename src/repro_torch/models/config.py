"""Architecture configuration schema (own copy of ``repro.models.config``).

Same field names and defaults as the reference ``ArchConfig``, so
``dataclasses.replace(cfg, compute_dtype="float32")`` works alike in both
packages; ``ShapeConfig``, ``SHAPES`` and ``cell_applicable`` name the
(arch × shape) cells as the reference does.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    head_dim: int
    d_ff: int                        # dense-MLP hidden
    vocab_size: int
    #: per-layer kinds, len == n_layers: attn | swa | enc | moe | ssm |
    #: hyb_g | hyb_l (see the reference schema for their meaning)
    layer_types: tuple[str, ...] = ()
    window: int = 0                  # SWA window
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU) | gelu_nogate
    # -- MoE --
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_renorm: bool = False
    moe_dispatch: str = "einsum"
    # -- SSM (Mamba2 SSD) --
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # -- attention details --
    rope_theta: float = 10_000.0
    rope_theta_global: float = 10_000.0
    causal: bool = True
    logit_softcap: float = 0.0
    embed_scale: bool = False        # gemma: embeddings × sqrt(d_model)
    tie_embeddings: bool = True
    qk_norm: bool = False
    input_mode: str = "tokens"       # tokens | embeds | mixed
    n_patches: int = 256
    norm_eps: float = 1e-6
    # -- runtime --
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots (training only)
    use_kernels: bool = False        # CPU tensors: plain kernel version; CUDA: always the kernel
    seq_shard: bool = False
    loss_chunk: int = 0
    vocab_pad: int = 0               # pad embed/logit tables to a multiple
    attn_q_chunk: int = 0            # stream attention query blocks

    def __post_init__(self) -> None:
        if self.layer_types and len(self.layer_types) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_types has {len(self.layer_types)} entries "
                f"for {self.n_layers} layers")

    # -- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad:
            return self.vocab_size
        p = self.vocab_pad
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def segments(self) -> list[tuple[str, int]]:
        """Consecutive same-kind runs → (kind, count) segments."""
        segs: list[tuple[str, int]] = []
        for kind in self.layer_types:
            if segs and segs[-1][0] == kind:
                segs[-1] = (kind, segs[-1][1] + 1)
            else:
                segs.append((kind, 1))
        return segs

    def has_decode(self) -> bool:
        """Encoder-only architectures have no autoregressive step."""
        return self.causal

    def subquadratic(self) -> bool:
        """True when the arch has at least one sub-quadratic sequence
        mechanism (SSM state or sliding window): it gates the long_500k
        cell; pure full-attention archs skip it."""
        return bool(set(self.layer_types) & {"swa", "ssm", "hyb_l"})

    def param_count(self) -> int:
        """Exact parameter count from the config (embedding included)."""
        d = self.d_model
        n = self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size
        if self.input_mode in ("embeds", "mixed"):
            n += d * d                                # frontend stub proj
        for kind in self.layer_types:
            n += d  # norm1
            if kind == "enc":
                n += d                                     # norm1 bias
            if kind in ("hyb_g", "hyb_l"):
                n += 2 * d                                 # branch norms
            if kind in ("attn", "swa", "enc", "moe", "hyb_g", "hyb_l"):
                n += d * self.n_heads * self.head_dim          # wq
                n += 2 * d * self.n_kv_heads * self.head_dim   # wk, wv
                n += self.n_heads * self.head_dim * d          # wo
                if self.qk_norm:
                    n += 2 * self.head_dim
            if kind in ("ssm", "hyb_g", "hyb_l"):
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                conv_ch = di + 2 * self.ssm_groups * N
                n += d * (2 * di + 2 * self.ssm_groups * N + H)  # in_proj
                n += self.ssm_conv * conv_ch + conv_ch           # conv + bias
                n += 3 * H                                       # A_log, D, dt_bias
                n += di                                          # gated norm
                n += di * d                                      # out_proj
            if kind == "moe":
                n += d * self.n_experts                          # router
                n += self.n_experts * 3 * d * self.moe_d_ff      # routed experts
                if self.n_shared_experts:
                    n += 3 * d * self.d_ff + d                   # shared expert (+gate)
                n += d                                           # norm2
            elif kind in ("attn", "swa", "enc", "hyb_g", "hyb_l"):
                if self.d_ff:
                    if self.mlp_act == "gelu_nogate":
                        n += 2 * d * self.d_ff + self.d_ff + d   # wi+wo+biases
                    else:
                        n += 3 * d * self.d_ff
                    n += d                                       # norm2
                    if kind == "enc":
                        n += d                                   # norm2 bias
        n += d                                                   # final norm
        if self.layer_types and self.layer_types[0] == "enc":
            n += d                                               # final bias
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        n_moe_layers = sum(1 for k in self.layer_types if k == "moe")
        inactive = (n_moe_layers * (self.n_experts - self.top_k) * 3
                    * self.d_model * self.moe_d_ff)
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs; returns (ok, reason-if-not)."""
    if shape.kind == "decode" and not cfg.has_decode():
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""
