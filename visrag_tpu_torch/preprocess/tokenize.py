"""Prompt construction + tokenization + batch assembly for VisRAG-Ret.

Parity with the reference flow (modeling_visrag_ret.py:57-126 +
modeling_minicpmv.py:173-200,247-274,404-479):
  * page prompt = <image>{unk×64}</image>[<slice>…]</slice>] + "\n" + text;
  * tokenize with BOS, truncate to max_inp_length, right-pad;
  * image bounds = (pos(im_start)+1, pos(im_end)) pairs, in order.

The device-side contract replaces per-sample image_bound lists with a static
(B, S) slot map: slot_map[b, s] = flat vision-token index, or -1 for text.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np


class TokenizerLike(Protocol):
    """Minimal tokenizer surface (reference LlamaTokenizerWrapper,
    modeling_minicpmv.py:404-438)."""
    bos_id: int
    unk_token: str
    im_start: str
    im_end: str
    slice_start: str
    slice_end: str
    im_start_id: int
    im_end_id: int

    def encode(self, text: str) -> List[int]: ...


@dataclasses.dataclass
class MockTokenizer:
    """Deterministic char-level tokenizer for tests (no sentencepiece dep).
    Special tokens are atomic."""
    bos_id: int = 1
    unk_token: str = "<unk>"
    im_start: str = "<image>"
    im_end: str = "</image>"
    slice_start: str = "<slice>"
    slice_end: str = "</slice>"
    unk_id: int = 0
    im_start_id: int = 101
    im_end_id: int = 102
    slice_start_id: int = 103
    slice_end_id: int = 104
    eos_ids: Tuple[int, ...] = ()     # generation runs its whole budget

    def encode(self, text: str) -> List[int]:
        specials = {self.unk_token: self.unk_id, self.im_start: self.im_start_id,
                    self.im_end: self.im_end_id,
                    self.slice_start: self.slice_start_id,
                    self.slice_end: self.slice_end_id}
        out: List[int] = []
        i = 0
        while i < len(text):
            for tok, tid in specials.items():
                if text.startswith(tok, i):
                    out.append(tid)
                    i += len(tok)
                    break
            else:
                out.append(200 + (ord(text[i]) % 50))
                i += 1
        return out

    def decode(self, ids) -> str:
        """A readable stand-in for generated ids (encode is not
        invertible): ids 200-249 become the characters '0'-'a' in order,
        every other id is dropped."""
        return "".join(chr(48 + i - 200) for i in ids if 200 <= i < 250)


class HFTokenizerAdapter:
    """Wrap a HuggingFace (fast) tokenizer into the TokenizerLike surface,
    with `decode` (special tokens skipped) and `eos_ids` (EOS, and ChatML's
    <|im_end|> where the vocab has it) for generation. Expects the
    MiniCPM-V special tokens to be present in the vocab."""

    def __init__(self, tok):
        self.tok = tok
        self.unk_token = tok.unk_token or "<unk>"
        self.im_start, self.im_end = "<image>", "</image>"
        self.slice_start, self.slice_end = "<slice>", "</slice>"
        self.bos_id = tok.bos_token_id
        self.im_start_id = tok.convert_tokens_to_ids(self.im_start)
        self.im_end_id = tok.convert_tokens_to_ids(self.im_end)
        self.slice_start_id = tok.convert_tokens_to_ids(self.slice_start)
        self.slice_end_id = tok.convert_tokens_to_ids(self.slice_end)
        self.eos_ids = [i for i in (tok.eos_token_id,
                                    tok.convert_tokens_to_ids("<|im_end|>"))
                        if isinstance(i, int) and i >= 0
                        and i != tok.unk_token_id]

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def image_placeholder(tok: TokenizerLike, query_num: int) -> str:
    return tok.im_start + tok.unk_token * query_num + tok.im_end


def grid_placeholder(tok: TokenizerLike, grid, query_num: int) -> str:
    """reference get_grid_placeholder (modeling_minicpmv.py:595-609)."""
    cols, rows = grid
    ph = image_placeholder(tok, query_num)
    lines = ["".join([ph] * cols) for _ in range(rows)]
    return tok.slice_start + "\n".join(lines) + tok.slice_end


def build_page_prompt(tok: TokenizerLike, text: str, grid,
                      query_num: int = 64) -> str:
    """Full prompt for a page with an image; grid=None when unsliced."""
    content = image_placeholder(tok, query_num)
    if grid is not None:
        content += grid_placeholder(tok, grid, query_num)
    return content + "\n" + text


def image_placeholder_v26(tok: TokenizerLike, grid, query_num: int = 64,
                          image_id=None) -> str:
    """MiniCPM-V 2.6 per-image placeholder: <image>unk*Q</image> for the
    source image, then EACH slice as its own <slice>unk*Q</slice>, columns
    concatenated and rows joined by newline; optional <image_id>i</image_id>
    prefix for multi-image prompts. Derived from the released 2.6
    checkpoint's image processor (no in-tree reference —
    visrag_scripts/generate/generate.py loads it via HF remote code)."""
    ph = image_placeholder(tok, query_num)
    if image_id is not None:
        ph = f"<image_id>{image_id}</image_id>" + ph
    if grid is not None:
        cols, rows = grid
        sl = tok.slice_start + tok.unk_token * query_num + tok.slice_end
        ph += "\n" + "\n".join("".join([sl] * cols) for _ in range(rows))
    return ph


def tokenize_prompt(tok: TokenizerLike, prompt: str,
                    max_inp_length: Optional[int] = 2048,
                    add_bos: bool = True) -> np.ndarray:
    ids = tok.encode(prompt)
    if add_bos:
        ids = [tok.bos_id] + ids
    if max_inp_length is not None:
        ids = ids[:max_inp_length]
    return np.asarray(ids, np.int32)


def image_bounds(ids: np.ndarray, im_start_id: int,
                 im_end_id: int) -> np.ndarray:
    """(n_images, 2) [start+1, end) bounds, reference _convert_to_tensors
    (modeling_minicpmv.py:173-200): pairs up to max(#starts, #ends) — after
    truncation a trailing unmatched start is dropped by the hstack zip."""
    starts = np.where(ids == im_start_id)[0] + 1
    ends = np.where(ids == im_end_id)[0]
    n = min(len(starts), len(ends))
    return np.stack([starts[:n], ends[:n]], axis=1) if n else np.zeros((0, 2), np.int64)


def vision_bounds(ids: np.ndarray, pairs) -> np.ndarray:
    """Region bounds over multiple delimiter pairs, sorted by start position.
    MiniCPM-V 2.0 wraps every region in <image>…</image>; 2.6 wraps the
    source image in <image>…</image> and EACH slice in <slice>…</slice>, so
    its slot map scans both pairs."""
    bs = [image_bounds(ids, s, e) for s, e in pairs]
    allb = np.concatenate([b for b in bs if len(b)] or
                          [np.zeros((0, 2), np.int64)], axis=0)
    return allb[np.argsort(allb[:, 0])] if len(allb) else allb


def build_slot_map(ids: np.ndarray, seq_len: int, im_start_id: int,
                   im_end_id: int, query_num: int,
                   slice_offset: int, extra_pairs=()) -> np.ndarray:
    """(seq_len,) int32 slot map. Vision tokens for the page's i-th image
    region occupy flat indices (slice_offset+i)*query_num + j."""
    out = np.full((seq_len,), -1, np.int32)
    bounds = vision_bounds(ids, [(im_start_id, im_end_id), *extra_pairs])
    for i, (s, e) in enumerate(bounds):
        span = min(e, seq_len) - s
        if span <= 0:
            continue
        base = (slice_offset + i) * query_num
        out[s:s + span] = base + np.arange(span, dtype=np.int32)
    return out


def pad_batch(id_list: Sequence[np.ndarray], max_len: Optional[int] = None):
    """Right-pad (reference pad(), modeling_minicpmv.py:440-479)."""
    if max_len is None:
        max_len = max(len(x) for x in id_list)
    b = len(id_list)
    ids = np.zeros((b, max_len), np.int32)
    mask = np.zeros((b, max_len), np.int32)
    for i, x in enumerate(id_list):
        n = min(len(x), max_len)
        ids[i, :n] = x[:n]
        mask[i, :n] = 1
    return ids, mask
