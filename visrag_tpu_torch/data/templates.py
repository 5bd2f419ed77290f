"""`<marker>` templating (reference src/openmatch/utils.py:208-255).

Templates like "Represent this query for retrieving relevant documents:
<query>" are filled from row dicts; markers support dotted paths; missing
markers either raise or warn-and-blank.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional


def find_all_markers(template: str) -> List[str]:
    markers = []
    start = 0
    while True:
        start = template.find("<", start)
        if start == -1:
            break
        end = template.find(">", start)
        if end == -1:
            break
        markers.append(template[start + 1:end])
        start = end + 1
    return markers


def fill_template(template: str, data: Dict,
                  markers: Optional[List[str]] = None,
                  allow_not_found: bool = False) -> str:
    if markers is None:
        markers = find_all_markers(template)
    for marker in markers:
        content = data
        found = True
        for level in marker.split("."):
            content = content.get(level) if isinstance(content, dict) else None
            if content is None:
                found = False
                break
        if not found:
            if allow_not_found:
                warnings.warn(f"Marker {marker!r} not found; using ''",
                              RuntimeWarning)
                content = ""
            else:
                raise ValueError(f"cannot find marker {marker!r} in data")
        template = template.replace(f"<{marker}>", str(content))
    return template
