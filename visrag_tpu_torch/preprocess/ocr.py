"""The port's copy of visrag_tpu/preprocess/ocr.py (pure Python, PIL).

OCR text-RAG baseline pipeline (gated backends).

Parity with the reference's visrag_scripts/demo/ocr_pipeline/*: page image →
(box, text) detections → layout-preserving text with adjacent-line merging.
The detection backend is pluggable: pytesseract if installed, or any callable
returning [(x0, y0, x1, y1, text), ...] — the PP-OCR/fastdeploy backend of
the reference is GPU-bound and not available in this image.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from PIL import Image

Detection = Tuple[float, float, float, float, str]  # x0, y0, x1, y1, text


def tesseract_backend(img: Image.Image) -> List[Detection]:
    try:
        import pytesseract
    except ImportError as e:
        raise ImportError("OCR needs pytesseract (not in this image) or a "
                          "custom backend callable") from e
    data = pytesseract.image_to_data(img, output_type=pytesseract.Output.DICT)
    out: List[Detection] = []
    for i, text in enumerate(data["text"]):
        if text.strip():
            x, y = data["left"][i], data["top"][i]
            w, h = data["width"][i], data["height"][i]
            out.append((x, y, x + w, y + h, text))
    return out


def merge_adjacent(dets: Sequence[Detection], *, y_tol: float = 0.6,
                   x_gap: float = 2.0) -> List[str]:
    """Layout-preserving line assembly: sort by (row, x), merge detections on
    the same baseline (y-overlap ≥ y_tol of min height) into one line, order
    lines top-to-bottom (the adjacent-merging role of the reference's
    ppocr pipeline)."""
    if not dets:
        return []
    rest = sorted(dets, key=lambda d: (d[1], d[0]))
    lines: List[List[Detection]] = []
    for d in rest:
        placed = False
        for line in lines:
            ref = line[-1]
            h = min(ref[3] - ref[1], d[3] - d[1])
            overlap = min(ref[3], d[3]) - max(ref[1], d[1])
            if h > 0 and overlap >= y_tol * h:
                line.append(d)
                placed = True
                break
        if not placed:
            lines.append([d])
    lines.sort(key=lambda line: min(d[1] for d in line))
    out = []
    for line in lines:
        line.sort(key=lambda d: d[0])
        out.append(" ".join(d[4] for d in line))
    return out


def layout_preserving_text(dets: Sequence[Detection], *,
                           space_threshold: float = 45.0,
                           line_threshold: float = 15.0) -> str:
    """PP-OCR layout-preserving merge — parity with the reference's
    tostr_layout_preserving + calculate_spaces_and_newlines
    (visrag_scripts/demo/ocr_pipeline/layout_preserving/demo.py:42-77),
    fuzz-tested against the AST-extracted originals: boxes sort by
    (center_y, center_x); consecutive boxes within line_threshold vertically
    join with max(1, |dx|/space_threshold) spaces, otherwise with
    max(1, |dy|/line_threshold) newlines — horizontal gaps and paragraph
    breaks survive into the text the text-RAG baseline retrieves over."""
    boxes = [((x0 + x1) / 2.0, (y0 + y1) / 2.0, text)
             for (x0, y0, x1, y1, text) in dets]
    boxes.sort(key=lambda b: (b[1], b[0]))
    parts: List[str] = []
    prev = None
    for cx, cy, text in boxes:
        if prev is not None:
            px, py = prev
            if abs(cy - py) < line_threshold:
                parts.append(" " * max(1, int(abs(cx - px) / space_threshold)))
            else:
                parts.append("\n" * max(1, int(abs(cy - py) / line_threshold)))
        parts.append(text)
        prev = (cx, cy)
    return "".join(parts)


def page_to_text(img: Image.Image,
                 backend: Optional[Callable[[Image.Image], List[Detection]]] = None,
                 layout: str = "lines") -> str:
    """layout="lines": baseline-merged lines (merge_adjacent);
    layout="preserve": the reference's layout-preserving spacing."""
    backend = backend or tesseract_backend
    dets = backend(img)
    if layout == "preserve":
        return layout_preserving_text(dets)
    return "\n".join(merge_adjacent(dets))
