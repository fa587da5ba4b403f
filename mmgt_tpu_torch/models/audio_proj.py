"""AudioProjModel (`mmgt_tpu/models/audio_proj.py`): per-frame wav2vec
window -> 32 context tokens, (B, F, 5, 12, 768) -> (B, F, 32, 768).
Under tensor parallelism proj1 and proj2 are both column shards (the JAX
rules), so proj1's output is gathered before proj2; proj3 is a row shard
completed by one reduce."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.nn.layers import LayerNorm, col_linear, row_linear, tp_mesh
from mmgt_tpu_torch.parallel.collectives import gather_last


class AudioProjModel(nn.Module):
    def __init__(self, seq_len: int = 5, blocks: int = 12, channels: int = 768,
                 intermediate_dim: int = 512, output_dim: int = 768,
                 context_tokens: int = 32):
        super().__init__()
        self.context_tokens, self.output_dim = context_tokens, output_dim
        self.proj1 = nn.Linear(seq_len * blocks * channels, intermediate_dim)
        self.proj2 = nn.Linear(intermediate_dim, intermediate_dim)
        self.proj3 = nn.Linear(intermediate_dim, context_tokens * output_dim)
        self.norm = LayerNorm(output_dim)

    def forward(self, audio_embeds):
        b, f = audio_embeds.shape[:2]
        x = audio_embeds.reshape(b * f, -1)
        # tp: proj1 and proj2 are column shards, so proj1's output is
        # gathered before proj2; proj3 is a row shard
        h = F.relu(col_linear(x, self.proj1))
        x = F.relu(col_linear(gather_last(h, tp_mesh(self)), self.proj2))
        x = row_linear(x, self.proj3).reshape(b * f, self.context_tokens, self.output_dim)
        return self.norm(x).reshape(b, f, self.context_tokens, self.output_dim)
