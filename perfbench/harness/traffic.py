"""The one generator of every traffic mix: it reads a mix's parameters
(traffic/<name>.json) and gives the files in the order a seed draws.

Parameters:
    clips       clip file names under clips/ (checked against the manifest)
    cut         "whole": each clip is one file; "gop": each clip is cut into
                its single-GOP Annex-B pieces (clips.gop_pieces)
    list_len    files handed to one call of a pool driver (a whole number of
                rounds keeps every list the same set of files)

Every round is the whole set of files once, in an order drawn from the seed;
rounds follow one another. So every seed sends the same files in the same
proportions, in another order.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from . import clips


@dataclass(frozen=True)
class Item:
    name: str    # unique among the mix's files: clip name, and ".gNN" for a piece
    data: bytes


def files(traffic: dict) -> list[Item]:
    """The mix's distinct files, in a fixed order."""
    loaded = clips.load(traffic["clips"])
    out = []
    for name in traffic["clips"]:
        if traffic["cut"] == "whole":
            out.append(Item(name, loaded[name]))
        elif traffic["cut"] == "gop":
            stem = name.rsplit(".", 1)[0]
            out += [Item(f"{stem}.g{g:02d}.264", p)
                    for g, p in enumerate(clips.gop_pieces(loaded[name]))]
        else:
            raise ValueError(f"traffic {traffic.get('name')}: unknown cut {traffic['cut']!r}")
    return out


class Stream:
    """The mix's files in seeded rounds; next() gives the next file."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic = traffic
        self.items = files(traffic)
        self.rng = random.Random(seed)
        self.round: list[Item] = []

    def __iter__(self):
        return self

    def __next__(self) -> Item:
        if not self.round:
            self.round = self.items[:]
            self.rng.shuffle(self.round)
        return self.round.pop()

    def take(self, k: int) -> list[Item]:
        return [next(self) for _ in range(k)]
