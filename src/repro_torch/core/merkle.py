"""Merkle-tree checksums (Bullion §2.1, Fig. 2).

Page hashes are leaves; each row group's checksum combines its page hashes;
the file checksum combines group checksums.  A page update therefore only
re-hashes the touched page + its group + the root — never the whole file,
unlike the monolithic whole-file checksums of legacy columnar formats.
"""

from __future__ import annotations

import hashlib

import numpy as np


def page_hash(data: bytes | memoryview) -> int:
    return int.from_bytes(hashlib.blake2b(bytes(data), digest_size=8).digest(), "little")


def combine(hashes: np.ndarray) -> int:
    """Order-sensitive combine of child hashes (u64 array)."""
    return page_hash(np.ascontiguousarray(hashes, np.uint64).tobytes())


class MerkleTree:
    """page checksums -> group checksums -> file checksum, with incremental
    update on page change."""

    def __init__(self, page_checksums: np.ndarray, chunk_page_start: np.ndarray,
                 n_groups: int, n_cols: int):
        self.pages = np.asarray(page_checksums, np.uint64).copy()
        self.chunk_page_start = np.asarray(chunk_page_start, np.uint64)
        self.n_groups = n_groups
        self.n_cols = n_cols
        self.groups = np.zeros(n_groups, np.uint64)
        for g in range(n_groups):
            self.groups[g] = combine(self._group_slice(g))
        self.root = combine(self.groups)
        self.hash_ops = 0  # instrumentation for the deletion benchmark

    def _group_slice(self, g: int) -> np.ndarray:
        s = int(self.chunk_page_start[g * self.n_cols])
        e = int(self.chunk_page_start[(g + 1) * self.n_cols])
        return self.pages[s:e]

    def group_of_page(self, page: int) -> int:
        # chunk_page_start is monotone; group boundaries every n_cols entries
        idx = int(np.searchsorted(self.chunk_page_start, page, side="right")) - 1
        return min(idx // self.n_cols, self.n_groups - 1)

    def update_page(self, page: int, new_data: bytes) -> None:
        """Incremental path: leaf -> group -> root (the red arrows in Fig. 2)."""
        self.pages[page] = np.uint64(page_hash(new_data))
        g = self.group_of_page(page)
        self.groups[g] = np.uint64(combine(self._group_slice(g)))
        self.root = combine(self.groups)
        self.hash_ops += 3

    def full_recompute(self) -> int:
        """Monolithic baseline: re-derive everything (legacy formats)."""
        for g in range(self.n_groups):
            self.groups[g] = np.uint64(combine(self._group_slice(g)))
        self.root = combine(self.groups)
        self.hash_ops += self.n_groups + 1
        return self.root
