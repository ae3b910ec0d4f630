"""SQL (Self-Query-Layer) depth decoder. Counterpart of
``sfmnext_tpu/models/sql_decoder.py`` with the reference's state-dict names
(``networks/depth_decoder_QTR.py``).

  1. patchify the 1/2-res feature map with Conv(k=p, s=p)
  2. add the first N rows of a learned 500-row positional table
  3. 4-layer post-LN transformer encoder, 4 heads (stock PyTorch, as the
     JAX package leaves it to XLA; LayerNorm eps 1e-6 as flax's default)
  4. the first ``query_nums`` tokens become the queries
  5. FullQueryLayer cross-attention against the conv3x3 feature map
  6. bins regressor MLP -> normalised bin widths        (float32)
  7. cumsum -> bin edges -> centers in [min_val, max_val] (float32)
  8. depth = sum(softmax(1x1 conv(energy)) * centers)

Steps 5 and 8 run as the Hopper kernels of ``ops/sql_kernel.py`` (forward
and backward) when ``use_kernels`` is set, the model computes in bf16 and
the energies are not asked for (the JAX rule at ``sql_decoder.py:224-229``
without its TPU tile gate); otherwise through the plain
``ops/sql_attention.py``. Steps 5-8 run outside autocast: the SQL ops fix
their own operand dtypes and the bins head stays float32. In training the
parameters stay float32 and the step runs the model under bf16 autocast
(``training/pipeline.py``); the transformer's dropout (p 0.1) is live in
train mode. The output ``disp0`` holds *depth*, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import torch_default_init_
from sfmnext_tpu_torch.ops import sql_attention, sql_kernel

NUM_TF_LAYERS = 4
MAX_TOKENS = 500  # rows of the positional table


class SQLDecoder(nn.Module):
    """Features [B,E,H,W] -> {"disp0": depth [B,1,H,W] float32,
    "bin_centers": [B,D] float32, and "energy" [B,H,W,Q] if asked for}."""

    def __init__(self, embedding_dim: int = 32, patch_size: int = 20,
                 num_heads: int = 4, query_nums: int = 128, dim_out: int = 128,
                 min_val: float = 0.001, max_val: float = 80.0,
                 ffn_dim: int = 1024, dtype=torch.float32, use_kernels: bool = True):
        super().__init__()
        e, q = embedding_dim, query_nums
        self.embedding_dim, self.patch_size = e, patch_size
        self.query_nums, self.dim_out = q, dim_out
        self.min_val, self.max_val = min_val, max_val
        self.dtype = dtype
        self.use_kernels = use_kernels

        self.embedding_convPxP = nn.Conv2d(e, e, patch_size, patch_size)
        self.positional_encodings = nn.Parameter(torch.empty(MAX_TOKENS, e))
        layer = nn.TransformerEncoderLayer(
            e, num_heads, ffn_dim, dropout=0.1, batch_first=True,
            layer_norm_eps=1e-6,
        )
        self.transformer_encoder = nn.TransformerEncoder(
            layer, NUM_TF_LAYERS, enable_nested_tensor=False
        )
        self.conv3x3 = nn.Conv2d(e, e, 3, 1, 1)
        # the bins head stays float32 whatever the compute dtype: the
        # normalised widths feed a cumsum that sets metric bin edges
        self.bins_regressor = nn.Sequential(
            nn.Linear(e * q, 16 * q), nn.LeakyReLU(0.01),
            nn.Linear(16 * q, 16 * 16), nn.LeakyReLU(0.01),
            nn.Linear(16 * 16, dim_out),
        )
        self.convert_to_prob = nn.Sequential(nn.Conv2d(q, dim_out, 1))
        for m in (self.embedding_convPxP, self.transformer_encoder, self.conv3x3):
            m.to(dtype)
        self.positional_encodings.data = self.positional_encodings.data.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """torch defaults; attention projections xavier-uniform per q/k/v
        with zero biases, and a U[0,1) positional table (the JAX inits)."""
        torch_default_init_(self, generator)
        e = self.embedding_dim
        for layer in self.transformer_encoder.layers:
            attn = layer.self_attn
            for i in range(3):
                nn.init.xavier_uniform_(attn.in_proj_weight[i * e:(i + 1) * e],
                                        generator=generator)
            nn.init.xavier_uniform_(attn.out_proj.weight, generator=generator)
            nn.init.zeros_(attn.in_proj_bias)
            nn.init.zeros_(attn.out_proj.bias)
        nn.init.uniform_(self.positional_encodings, 0.0, 1.0, generator=generator)

    def forward(self, x0: torch.Tensor, return_energy: bool = False):
        b, _, h, w = x0.shape
        p = self.patch_size
        n_tokens = (h // p) * (w // p)
        if n_tokens > MAX_TOKENS:
            raise ValueError(
                f"{n_tokens} patch tokens exceed the positional table "
                f"({MAX_TOKENS}); shrink the input or grow the patches")
        if n_tokens < self.query_nums:
            raise ValueError(
                f"query_nums={self.query_nums} > {n_tokens} tokens; "
                "queries are the first query_nums transformer outputs")
        x0 = x0.to(self.dtype)

        emb = self.embedding_convPxP(x0).flatten(2).transpose(1, 2)  # [B,T,E]
        emb = emb + self.positional_encodings[:n_tokens].to(emb.dtype)
        tokens = self.transformer_encoder(emb)
        queries = tokens[:, : self.query_nums]  # [B,Q,E]

        # [B,H,W,E]: the kernels' pixel-major layout, one permute for both
        feats = self.conv3x3(x0).permute(0, 2, 3, 1)
        with torch.autocast(x0.device.type, enabled=False):
            feats = feats.to(self.dtype).contiguous()
            queries = queries.to(self.dtype).contiguous()
            fused = (self.use_kernels and self.dtype == torch.bfloat16
                     and not return_energy)
            if fused:
                energy = None
                summary = sql_kernel.sql_summary(feats, queries)
            else:
                energy, summary = sql_attention.sql_full_query(feats, queries)

            z = self.bins_regressor(summary.float().reshape(b, -1))
            z = F.relu(z) + 0.1
            z = z / z.sum(dim=1, keepdim=True)
            widths = (self.max_val - self.min_val) * z
            widths = F.pad(widths, (1, 0), value=self.min_val)
            edges = torch.cumsum(widths, dim=1)
            centers = 0.5 * (edges[:, :-1] + edges[:, 1:])  # [B,D]

            prob = self.convert_to_prob[0]
            weight = prob.weight[:, :, 0, 0].t()  # [Q,D]
            if fused:
                depth = sql_kernel.sql_depth(
                    feats, queries, weight.to(torch.bfloat16).contiguous(),
                    prob.bias.float(), centers,
                )
            else:
                depth = sql_attention.sql_bins_to_depth(
                    energy, weight, prob.bias, centers, compute_dtype=self.dtype
                )

        out = {"disp0": depth.float().permute(0, 3, 1, 2), "bin_centers": centers}
        if return_energy:
            out["energy"] = energy
        return out
