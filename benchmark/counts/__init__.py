"""The benchmark's arithmetic: operations, bytes and FLOPs from shapes and
widths, and the card's published peaks.  Nothing here reads the program."""

import json
import os


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)
