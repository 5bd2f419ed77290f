"""Training / inference datasets for the retriever.

Parity with the reference data layer (SURVEY.md §2 O8-O10):
  * MMDRTrainDataset (dataset/train_dataset.py:135-166): parquet rows
    {query, image{bytes}} → query item (instruction template + text, no image)
    and passage items ('' text + page image); length from HF split info or a
    sibling metadata.json {"length": N} (:84-102);
  * InferenceDataset (dataset/inference_dataset.py): extension dispatch
    (parquet/tsv/jsonl/in-memory), id extraction trying
    _id/id/text_id/sample_id/filename/corpus-id/query-id (:25-42), template
    fill, empty docs → "empty document" (:239-241);
  * round-robin shard-by-batch-window iteration (:261-280) so every data
    shard sees an identical number of batches.

Everything is plain-python iterators feeding the host preprocessing pipeline;
device sharding happens downstream via NamedShardings.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

from PIL import Image

QUERY_INSTRUCTION = ("Represent this query for retrieving relevant documents: ")


def get_idx(obj: Dict[str, Any]) -> str:
    for key in ("_id", "id", "text_id", "sample_id", "filename", "corpus-id",
                "query-id"):
        if obj.get(key) is not None:
            return str(obj[key])
    raise ValueError("no id field found (tried _id/id/text_id/sample_id/"
                     "filename/corpus-id/query-id)")


def to_pil(image_field) -> Optional[Image.Image]:
    """HF image structs come as {'bytes': ..} or PIL or base64 str.

    Decodes EAGERLY (.load()): Image.open is lazy, and a lazily-loaded image
    handed to the threadpooled preprocess pipeline races its first decode
    across threads (PIL's self.fp is not thread-safe)."""
    if image_field is None:
        return None
    if isinstance(image_field, Image.Image):
        img = image_field
    elif isinstance(image_field, dict) and image_field.get("bytes"):
        img = Image.open(io.BytesIO(image_field["bytes"]))
    elif isinstance(image_field, (bytes, bytearray)):
        img = Image.open(io.BytesIO(image_field))
    elif isinstance(image_field, str):
        import base64
        img = Image.open(io.BytesIO(base64.b64decode(image_field)))
    else:
        raise TypeError(f"cannot decode image field {type(image_field)}")
    img.load()
    return img


def is_hf_repo(path: str) -> bool:
    """True for a hub spec 'org/name[@split]' that is not a local path (the
    reference's from_hf_repo switch, dataset/train_dataset.py:65-105).
    A missing local path with a data-file extension (a typo'd
    'data/train.parquet') must NOT be treated as a hub spec — that would
    swallow the FileNotFoundError and try to stream an unrelated public
    dataset."""
    import re
    stem = path.partition("@")[0]
    if stem.lower().endswith((".parquet", ".jsonl", ".json", ".tsv",
                              ".csv", ".txt", ".gz")):
        return False
    return (not os.path.exists(path)
            and re.fullmatch(r"[\w.\-]+/[\w.\-]+(@[\w.\-]+)?", path)
            is not None)


def iter_hf_rows(spec: str, streaming: bool = True) -> Iterator[Dict[str, Any]]:
    """HF-hub dataset rows (reference train_dataset.py:65-105 /
    inference_dataset.py:114-190 `from_hf_repo`): 'org/name[@split]' →
    datasets.load_dataset(streaming=True). Import-gated: environments
    without the `datasets` package (or network) fail loudly here only when
    a hub spec is actually used."""
    try:
        import datasets
    except ImportError as e:
        raise ImportError(
            f"{spec!r} looks like a HF-hub dataset but the `datasets` "
            "package is not installed; pass a local file/dir instead") from e
    name, _, split = spec.partition("@")
    ds = datasets.load_dataset(name, split=split or "train",
                               streaming=streaming)
    yield from ds


def hf_dataset_length(spec: str) -> Optional[int]:
    """Split row count from hub metadata without downloading data
    (reference __len__ via HF split info, train_dataset.py:84-102)."""
    try:
        import datasets
    except ImportError:
        return None
    name, _, split = spec.partition("@")
    try:
        info = datasets.load_dataset_builder(name).info
        return info.splits[split or "train"].num_examples
    except Exception:
        return None


def iter_rows(path: str, streaming: bool = True) -> Iterator[Dict[str, Any]]:
    """Extension-dispatch row iterator: .parquet / .tsv / .jsonl / .json, a
    directory of numbered shards in those formats (the reference's
    train_dataset layout: examples/training_data/{0.parquet, metadata.json}),
    or a HF-hub spec 'org/name[@split]' streamed via the datasets package."""
    if is_hf_repo(path):
        yield from iter_hf_rows(path, streaming)
        return
    if os.path.isdir(path):
        def _order(f):
            # numbered shards (0.parquet … 11.parquet) sort numerically —
            # lexicographic would yield 0,1,10,11,2,… and diverge from the
            # reference reader's row order
            stem = os.path.splitext(f)[0]
            return (0, int(stem), f) if stem.isdigit() else (1, 0, f)
        shards = sorted(
            (f for f in os.listdir(path)
             if os.path.splitext(f)[1].lower() in
             (".parquet", ".tsv", ".txt", ".jsonl") and f != "metadata.json"),
            key=_order)
        if not shards:
            raise ValueError(f"no data shards in directory {path!r}")
        for f in shards:
            yield from iter_rows(os.path.join(path, f), streaming)
        return
    ext = os.path.splitext(path)[1].lower()
    if ext == ".parquet":
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(path)
        for batch in pf.iter_batches(batch_size=64):
            yield from batch.to_pylist()
    elif ext in (".tsv", ".txt"):
        with open(path) as f:
            header = f.readline().rstrip("\n").split("\t")
            for line in f:
                yield dict(zip(header, line.rstrip("\n").split("\t")))
    elif ext == ".jsonl":
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)
    elif ext == ".json":
        with open(path) as f:
            data = json.load(f)
        yield from data
    else:
        raise ValueError(f"unsupported data extension {ext!r}")


def dataset_length(path: str) -> Optional[int]:
    """metadata.json {"length": N} next to the data files
    (train_dataset.py:84-102; examples/training_data/metadata.json), or HF
    split info for hub specs."""
    if is_hf_repo(path):
        return hf_dataset_length(path)
    meta = os.path.join(path if os.path.isdir(path) else os.path.dirname(path),
                        "metadata.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f).get("length")
    return None


class MMDRTrainDataset:
    """Query–page training pairs. Yields dicts:
      {"query": (text, None), "passages": [(text, PIL.Image), ...]}.
    """

    def __init__(self, path: str, query_template: str = None,
                 n_passages: int = 1):
        from .templates import fill_template
        self.path = path
        # query_template: "<query>"-marker template (DataConfig.query_template
        # / reference DataArguments.query_template); default = the paper's
        # retrieval instruction prefix
        self.template = query_template or (QUERY_INSTRUCTION + "<query>")
        self._fill = fill_template
        self.n_passages = n_passages
        self.length = dataset_length(path)

    def __len__(self):
        if self.length is None:
            raise TypeError("streaming dataset without metadata.json length")
        return self.length

    def __iter__(self):
        for row in iter_rows(self.path):
            query = self._fill(self.template, {"query": row["query"]})
            image = to_pil(row.get("image"))
            yield {"query": (query, None),
                   "passages": [("", image)] * 1}


class InferenceDataset:
    """Corpus/query encode stream. Yields (id, text, image)."""

    def __init__(self, path: str, template: str = "<text>",
                 mode: str = "multimodal"):
        from .templates import fill_template
        self.path = path
        self.template = template
        self.mode = mode
        self._fill = fill_template

    def __iter__(self):
        for row in iter_rows(self.path):
            rid = get_idx(row)
            text = self._fill(self.template, row, allow_not_found=True)
            image = to_pil(row.get("image")) if self.mode == "multimodal" else None
            if not text and image is None:
                text = "empty document"   # inference_dataset.py:239-241
            yield rid, text, image


def shard_round_robin(iterable: Iterable, batch_size: int, shard_index: int,
                      num_shards: int) -> Iterator:
    """Round-robin sharding by batch window (inference_dataset.py:261-280):
    each shard takes its contiguous batch_size slice of every
    batch_size×num_shards window."""
    window = batch_size * num_shards
    lo = shard_index * batch_size
    hi = lo + batch_size
    buf: List = []
    for item in iterable:
        buf.append(item)
        if len(buf) == window:
            yield from buf[lo:hi]
            buf = []
    if buf:
        yield from buf[lo:min(hi, len(buf))]


class StatefulIterator:
    """Checkpointable cursor over a re-creatable stream — the reference's
    StatefulDataLoader role (rsgrpo ray_trainer.py:332-334, 368-373): resume
    continues at the exact row instead of replaying/skipping by step count
    (which silently diverges for streaming data).

    make_iter() must return the SAME deterministic stream each call (a
    file-backed dataset; seed any shuffle). state() is a small JSON dict;
    set_state() fast-forwards a fresh stream lazily on the next next() —
    cheap for these datasets because PIL.Image.open is lazy (no pixel
    decode until the preprocess pipeline touches skipped rows' images).

    cycle=True restarts the stream at StopIteration, incrementing .epoch
    (row resets to 0) — the epoch loop for trainers."""

    def __init__(self, make_iter: Callable[[], Iterable],
                 cycle: bool = False):
        self.make_iter = make_iter
        self.cycle = cycle
        self.epoch = 0
        self.row = 0
        self._it: Optional[Iterator] = None

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "row": self.row}

    def set_state(self, st: Dict[str, int]) -> None:
        self.epoch = int(st["epoch"])
        self.row = int(st["row"])
        self._it = None     # fast-forward lazily on next __next__

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._it is None:
                self._it = iter(self.make_iter())
                for _ in range(self.row):
                    next(self._it)
            try:
                item = next(self._it)
                self.row += 1
                return item
            except StopIteration:
                if not self.cycle:
                    raise
                if self.row == 0:
                    raise RuntimeError("StatefulIterator: empty stream "
                                       "(cycle=True would spin forever)")
                self.epoch += 1
                self.row = 0
                self._it = None


def batched(iterable: Iterable, batch_size: int) -> Iterator[List]:
    buf: List = []
    for item in iterable:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def qp_collate(items: List[Dict]) -> Dict[str, List]:
    """MMQPCollator semantics (dataset/data_collator.py:21-32): list-of-dicts
    → dict of lists; queries and flattened passages stay raw (strings + PIL),
    tokenization happens in the preprocess pipeline."""
    queries = [it["query"] for it in items]
    passages = [p for it in items for p in it["passages"]]
    return {"queries": queries, "passages": passages}


class RLHFDataset:
    """RS-GRPO prompt dataset (verl/utils/dataset.py role): rows with
    {problem/prompt, answer, images?}; yields engine-ready prompt dicts after
    tokenization by the caller-provided encode_fn."""

    def __init__(self, path: str, encode_fn: Callable[[Dict], Dict],
                 max_prompt_length: Optional[int] = None):
        self.path = path
        self.encode_fn = encode_fn
        self.max_prompt_length = max_prompt_length

    def __iter__(self):
        for row in iter_rows(self.path):
            item = self.encode_fn(row)
            if item is None:
                continue
            if (self.max_prompt_length is not None and
                    len(item["input_ids"]) > self.max_prompt_length):
                continue  # filter overlong prompts (dataset.py:146-151)
            yield item


def load_video_frames(path: str, *, fps: float = 2.0,
                      max_frames: int = 32) -> List["Image.Image"]:
    """Decode video frames for RLHFDataset prompts (the reference's
    qwen_vl_utils.process_video role, utils/dataset.py:81-85). Uses imageio
    when present, falls back to PIL for multi-frame formats (GIF); raises a
    clear error otherwise (this image ships no ffmpeg bindings)."""
    from PIL import Image, ImageSequence

    try:
        import imageio.v3 as iio
        meta = iio.immeta(path)
        src_fps = float(meta.get("fps", fps) or fps)
        step = max(int(round(src_fps / fps)), 1)
        frames = [Image.fromarray(f) for i, f in enumerate(iio.imiter(path))
                  if i % step == 0]
        return frames[:max_frames]
    except ImportError:
        pass
    try:
        im = Image.open(path)
        frames = [f.convert("RGB").copy()
                  for f in ImageSequence.Iterator(im)]
        if len(frames) >= 1:
            step = max(len(frames) // max_frames, 1)
            return frames[::step][:max_frames]
    except Exception:
        pass
    raise RuntimeError(
        f"cannot decode video {path!r}: no imageio/ffmpeg in this image; "
        "pass pre-decoded frames (a list of PIL images) instead")
