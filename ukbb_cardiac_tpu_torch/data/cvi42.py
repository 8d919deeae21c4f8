"""cvi42 workspace (.cvi42wsx XML) contour parser.

Counterpart of ``ukbb_cardiac_tpu/data/cvi42.py`` (a copy).

Twin of ``data/parse_cvi42_xml.py``: walks the DOM for ``ImageStates``
entries keyed by DICOM SOP-instance UID, extracts each contour's point
list, divides by the SubpixelResolution and pickles one dict per UID
(the format ``Biobank_Dataset.rasterise_contours`` consumes).

Implementation uses ``xml.etree.ElementTree``'s iterparse-free API with
explicit attribute matching rather than recursive minidom traversal.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict
from xml.etree import ElementTree

import numpy as np

_HASH_KEY = "{http://www.circlecvi.com/cvi42/Workspace/Hash/}key"
_POINT_NS = "{http://www.circlecvi.com/cvi42/Workspace/Point/}"


def _hash_key(elem) -> str:
    return elem.get(_HASH_KEY, elem.get("Hash:key", ""))


def parse_contours(contours_elem) -> Dict[str, np.ndarray]:
    """One ``Contours`` container → {contour name: (N, 2) points}
    (``parse_cvi42_xml.py:37-58``)."""
    contours = {}
    for contour in contours_elem:
        name = _hash_key(contour)
        points = []
        sub = 1
        for item in contour:
            key = _hash_key(item)
            if key == "Points":
                for pt in item:
                    x = y = None
                    for coord in pt:
                        tag = coord.tag.split("}")[-1]
                        if tag == "x":
                            x = float(coord.text)
                        elif tag == "y":
                            y = float(coord.text)
                    if x is not None and y is not None:
                        points.append([x, y])
            elif key == "SubpixelResolution":
                sub = int(item.text)
        if points:
            contours[name] = np.asarray(points) / sub
    return contours


def parse_workspace(xml_name: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Whole workspace → {dicom UID: {contour name: points}}."""
    tree = ElementTree.parse(xml_name)
    uid_contours: Dict[str, Dict[str, np.ndarray]] = {}
    for elem in tree.iter():
        if _hash_key(elem) == "ImageStates":
            for image_state in elem:
                uid = _hash_key(image_state)
                for item in image_state:
                    if _hash_key(item) == "Contours":
                        contours = parse_contours(item)
                        if contours:
                            uid_contours[uid] = contours
    return uid_contours


def parseFile(xml_name: str, output_dir: str) -> None:
    """Parse + pickle per-UID contour dicts (``parse_cvi42_xml.py:80-89``)."""
    for uid, contours in parse_workspace(xml_name).items():
        with open(os.path.join(output_dir, f"{uid}.pickle"), "wb") as f:
            pickle.dump(contours, f)
