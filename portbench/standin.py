"""A stand-in for Qwen2.5-VL's tokenizer and processor: the chat template
of the released processor, its special tokens as atomic ids, and every
other word hashed into the text vocabulary. No file is read."""

from __future__ import annotations

import re
import zlib


class StandInTokenizer:
    image_token = "<|image_pad|>"

    def __init__(self, cfg: dict, text_vocab: int):
        """cfg: the configuration's token ids (image_token_id,
        vision_start_token_id, vision_end_token_id, eos_token_id, and
        im_start_id / im_end_id where they differ from the released
        model's)."""
        self.special = {
            "<|im_start|>": cfg.get("im_start_id", 151644),
            "<|im_end|>": cfg["eos_token_id"],
            "<|vision_start|>": cfg["vision_start_token_id"],
            "<|vision_end|>": cfg["vision_end_token_id"],
            "<|image_pad|>": cfg["image_token_id"],
        }
        self.eos_token_id = cfg["eos_token_id"]
        self.text_vocab = text_vocab
        self._split = re.compile("(" + "|".join(
            re.escape(t) for t in self.special) + ")")

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        out = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        for m in messages:
            body = "".join(
                "<|vision_start|><|image_pad|><|vision_end|>"
                if c["type"] == "image" else c["text"]
                for c in m["content"])
            out += f"<|im_start|>{m['role']}\n{body}<|im_end|>\n"
        return out + ("<|im_start|>assistant\n" if add_generation_prompt
                      else "")

    def convert_tokens_to_ids(self, token):
        return self.special[token]

    def encode(self, text):
        ids = []
        for part in self._split.split(text):
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids.extend(zlib.crc32(w.encode()) % self.text_vocab
                           for w in part.split())
        return ids
