"""TextEncoder: relation-type string → dense embedding.

The port of ``graph_hypernetwork_forge_tpu/models/text_encoder.py``: a
char-level bag of embeddings. Each character is a code ``min(ord(c), 127)``
(the empty string is the single code 0), looked up in a ``[128,
char_emb_dim]`` table, mean-pooled over the real characters, projected by a
Linear and squashed with tanh. Texts are tokenized once on the host into a
padded ``[U, L]`` matrix and lengths.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    embedding_params,
    linear_apply,
    linear_params,
    tree_to,
)
from graph_hypernetwork_forge_tpu_torch.utils.text import ASCII_VOCAB, tokenize_texts


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    text_dim: int
    char_emb_dim: int = 32
    vocab_size: int = ASCII_VOCAB


def init_text_encoder(config: TextEncoderConfig, gen: torch.Generator) -> dict:
    return {
        "char_emb": embedding_params(gen, config.vocab_size, config.char_emb_dim),
        "proj": linear_params(gen, config.char_emb_dim, config.text_dim),
    }


def apply_text_encoder(
    params: dict, char_ids: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """``[U, L]`` char ids + ``[U]`` lengths → ``[U, text_dim]``.

    The masked mean runs over exactly the real characters.
    """
    emb = params["char_emb"][char_ids]  # [U, L, C]
    max_len = char_ids.shape[-1]
    mask = (
        torch.arange(max_len, device=char_ids.device)[None, :] < lengths[:, None]
    )
    pooled = (emb * mask[..., None]).sum(dim=-2) / lengths.clamp(min=1).to(
        emb.dtype
    )[:, None]
    return torch.tanh(linear_apply(params["proj"], pooled))


class TextEncoder:
    """``encode_one(text)`` → ``[text_dim]``; ``__call__(texts)`` →
    ``[len(texts), text_dim]``, on ``device`` (``None`` = the CUDA card)."""

    def __init__(
        self, text_dim: int, char_emb_dim: int = 32, *, seed: int = 0,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = TextEncoderConfig(text_dim=text_dim, char_emb_dim=char_emb_dim)
        self.text_dim = text_dim
        gen = torch.Generator().manual_seed(seed)
        self.params = tree_to(init_text_encoder(self.config, gen), self.device)

    def encode_one(self, text: str) -> torch.Tensor:
        return self([text])[0]

    @torch.inference_mode()
    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        char_ids, lengths = tokenize_texts(texts)
        return apply_text_encoder(
            self.params,
            torch.as_tensor(char_ids, device=self.device),
            torch.as_tensor(lengths, device=self.device),
        )
