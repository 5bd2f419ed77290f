"""The port's copy of visrag_tpu/preprocess/rasterize.py (pure Python).

Document → page images (the file2img role).

Parity with the reference's visrag_scripts/file2img/* and
demo/visrag_pipeline/build_index.py:32-44: PDFs rasterize at a configurable
DPI (reference uses 200 for the demo, 300 for file2img); plain text renders
to simple page images. Office formats (doc/ppt via win32com in the reference)
are Windows-COM-bound and unsupported here — convert to PDF upstream.

Backends are gated: PyMuPDF (fitz) preferred, pdf2image fallback; a clear
error names the missing dependency.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

from PIL import Image


def pdf_to_images(path: str, dpi: int = 200) -> Iterator[Image.Image]:
    try:
        import fitz  # PyMuPDF
    except ImportError:
        fitz = None
    if fitz is not None:
        doc = fitz.open(path)
        for page in doc:
            pix = page.get_pixmap(dpi=dpi)
            yield Image.frombytes("RGB", (pix.width, pix.height), pix.samples)
        return
    try:
        from pdf2image import convert_from_path
    except ImportError as e:
        raise ImportError(
            "PDF rasterization needs PyMuPDF (fitz) or pdf2image; neither is "
            "installed in this environment") from e
    yield from convert_from_path(path, dpi=dpi)


def text_to_images(path: str, *, page_chars: int = 3000,
                   size=(1240, 1754), margin: int = 60,
                   font_size: int = 22) -> Iterator[Image.Image]:
    """Plain-text → simple rendered pages (the txt2pdf+rasterize role)."""
    from PIL import ImageDraw

    with open(path, errors="replace") as f:
        text = f.read()
    chunks = [text[i:i + page_chars] for i in range(0, len(text), page_chars)] or [""]
    for chunk in chunks:
        img = Image.new("RGB", size, "white")
        draw = ImageDraw.Draw(img)
        # naive wrap
        width_chars = max(20, (size[0] - 2 * margin) // (font_size // 2))
        lines: List[str] = []
        for para in chunk.split("\n"):
            while len(para) > width_chars:
                lines.append(para[:width_chars])
                para = para[width_chars:]
            lines.append(para)
        draw.multiline_text((margin, margin), "\n".join(lines), fill="black")
        yield img


OFFICE_EXTS = (".doc", ".docx", ".ppt", ".pptx", ".xls", ".xlsx", ".odt",
               ".odp", ".ods", ".rtf")


def office_to_pdf(path: str, out_dir: Optional[str] = None) -> str:
    """Office document → PDF via LibreOffice headless — the cross-platform
    stand-in for the reference's Windows-COM converters
    (visrag_scripts/file2img/{doc,ppt}2pdf.py use win32com.client Word/
    PowerPoint, which cannot exist off Windows). Gated on a `soffice`
    binary; raises a clear error naming the dependency otherwise."""
    import shutil
    import subprocess
    import tempfile

    soffice = shutil.which("soffice") or shutil.which("libreoffice")
    if soffice is None:
        raise RuntimeError(
            f"converting {os.path.basename(path)!r} needs LibreOffice "
            "(`soffice` not on PATH; the reference's doc2pdf/ppt2pdf are "
            "win32com-bound) — install libreoffice or convert to PDF "
            "upstream")
    out_dir = out_dir or tempfile.mkdtemp(prefix="visrag_office_")
    subprocess.run([soffice, "--headless", "--convert-to", "pdf",
                    "--outdir", out_dir, path], check=True,
                   capture_output=True, timeout=300)
    pdf = os.path.join(
        out_dir, os.path.splitext(os.path.basename(path))[0] + ".pdf")
    if not os.path.exists(pdf):
        raise RuntimeError(f"LibreOffice produced no PDF for {path!r}")
    return pdf


def file_to_images(path: str, dpi: int = 200) -> Iterator[Image.Image]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pdf":
        yield from pdf_to_images(path, dpi)
    elif ext in (".txt", ".md"):
        yield from text_to_images(path)
    elif ext in (".png", ".jpg", ".jpeg", ".webp", ".bmp"):
        yield Image.open(path).convert("RGB")
    elif ext in OFFICE_EXTS:
        yield from pdf_to_images(office_to_pdf(path), dpi)
    else:
        raise ValueError(f"unsupported document type {ext!r}")
