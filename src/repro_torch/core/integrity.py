"""Decode-time integrity: checksum verification, quarantine, policies.

Bullion's compliance story (paper §2.1) rests on verifiable storage — every
page carries a blake2b checksum in ``Sec.PAGE_CHECKSUM`` — but checksums
that are only consulted by the offline ``bullion fsck`` do nothing for a
live reader. This module closes that gap on the hot read path:

* **Verification policy** (``BULLION_VERIFY=off|sample|full``, default
  ``sample``): every batch of page bytes the reader materializes is hashed
  against the footer before decode. ``sample`` verifies each page once per
  process-wide footer-cache entry (the memo rides the shared ``FooterView``
  object, so re-opens served from the cache stay verified); ``full``
  re-verifies on every read; remote backends always verify fully — a flaky
  HTTP body is far more likely than local bit rot.
* **One re-read before declaring corruption**: a mismatch triggers a single
  direct pread (local) or a fresh ranged GET outside the coalesced run
  (remote). Transient faults — a truncated response body spliced into a
  coalesced run, a torn page cache — recover invisibly; only a *persistent*
  mismatch quarantines the page.
* **Quarantine + graceful degradation** (``BULLION_ON_CORRUPT=
  raise|skip|mask``, default ``raise``): the process-wide
  ``QuarantineRegistry`` records corrupt (shard, group, page) triples keyed
  to the exact ``FooterView`` object that was corrupt. Quarantining a page
  drops the shard from the footer cache (``notify_footer_rewrite``), so an
  out-of-band repair is picked up by stat/ETag revalidation without a
  process restart — the repaired file parses to a *new* footer object and
  the stale quarantine entry self-invalidates. ``skip`` drops the page's
  rows with exact accounting in ``IOStats.degraded_rows``; ``mask`` serves
  shape-stable zero fill for training loaders that prefer a few garbage
  rows over a dead input pipeline.

Event counts flow through ``IOStats`` (``pages_verified`` /
``checksum_failures`` / ``pages_quarantined`` / ``degraded_rows``) and the
``bullion.integrity.*`` metrics.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from ..obs import metrics as _metrics
from .footer import Sec, ShardCorruptError, notify_footer_rewrite
from .merkle import page_hash

__all__ = [
    "ShardCorruptError", "QuarantineRegistry", "QUARANTINE",
    "verify_policy", "set_verify_policy", "corruption_policy",
    "set_corruption_policy", "verify_pages", "page_group",
    "VERIFY_OFF", "VERIFY_SAMPLE", "VERIFY_FULL",
    "ON_CORRUPT_RAISE", "ON_CORRUPT_SKIP", "ON_CORRUPT_MASK",
]

VERIFY_OFF = "off"
VERIFY_SAMPLE = "sample"
VERIFY_FULL = "full"
_VERIFY_POLICIES = (VERIFY_OFF, VERIFY_SAMPLE, VERIFY_FULL)

ON_CORRUPT_RAISE = "raise"
ON_CORRUPT_SKIP = "skip"
ON_CORRUPT_MASK = "mask"
_CORRUPT_POLICIES = (ON_CORRUPT_RAISE, ON_CORRUPT_SKIP, ON_CORRUPT_MASK)

_policy_lock = threading.Lock()
_verify_override: Optional[str] = None
_corrupt_override: Optional[str] = None


def _env_policy(var: str, allowed: tuple, default: str) -> str:
    val = os.environ.get(var, "").strip().lower()
    if not val:
        return default
    if val not in allowed:
        raise ValueError(
            f"{var}={val!r}: expected one of {', '.join(allowed)}")
    return val


def verify_policy() -> str:
    """Active verification policy: programmatic override, else the
    ``BULLION_VERIFY`` environment variable, else ``sample``."""
    with _policy_lock:
        if _verify_override is not None:
            return _verify_override
    return _env_policy("BULLION_VERIFY", _VERIFY_POLICIES, VERIFY_SAMPLE)


def set_verify_policy(policy: Optional[str]) -> None:
    """Override ``BULLION_VERIFY`` in-process (``None`` clears)."""
    global _verify_override
    if policy is not None and policy not in _VERIFY_POLICIES:
        raise ValueError(
            f"verify policy {policy!r}: expected one of "
            f"{', '.join(_VERIFY_POLICIES)}")
    with _policy_lock:
        _verify_override = policy


def corruption_policy() -> str:
    """Active corruption policy: programmatic override, else the
    ``BULLION_ON_CORRUPT`` environment variable, else ``raise``."""
    with _policy_lock:
        if _corrupt_override is not None:
            return _corrupt_override
    return _env_policy("BULLION_ON_CORRUPT", _CORRUPT_POLICIES,
                       ON_CORRUPT_RAISE)


def set_corruption_policy(policy: Optional[str]) -> None:
    """Override ``BULLION_ON_CORRUPT`` in-process (``None`` clears)."""
    global _corrupt_override
    if policy is not None and policy not in _CORRUPT_POLICIES:
        raise ValueError(
            f"corruption policy {policy!r}: expected one of "
            f"{', '.join(_CORRUPT_POLICIES)}")
    with _policy_lock:
        _corrupt_override = policy


def page_group(fv, page: int) -> int:
    """Row group owning a physical page (groups partition pages)."""
    gps = fv.group_page_start()
    return int(np.searchsorted(gps, page, side="right")) - 1


# ---------------------------------------------------------------------------
# quarantine registry
# ---------------------------------------------------------------------------

class QuarantineRegistry:
    """Process-wide record of corrupt (shard, group, page) triples.

    Entries are keyed to the *identity* of the ``FooterView`` that was
    corrupt: the footer cache hands the same object to every reader of an
    unchanged file, and drops it when the shard is quarantined or
    rewritten. A repaired (or still-corrupt-but-replaced) file parses to a
    fresh footer object, so stale entries self-invalidate on the next
    lookup — recovery needs no process restart and no explicit clear."""

    def __init__(self):
        self._lock = threading.Lock()
        # path -> {"footer": FooterView, "pages": {page: (group, reason)}}
        self._shards: dict[str, dict] = {}

    def add(self, path: str, fv, group: int, page: int, reason: str) -> bool:
        """Record one corrupt page; returns True if it is newly recorded."""
        with self._lock:
            ent = self._shards.get(path)
            if ent is None or ent["footer"] is not fv:
                ent = self._shards[path] = {"footer": fv, "pages": {}}
            fresh = page not in ent["pages"]
            ent["pages"][page] = (int(group), reason)
        return fresh

    def lookup(self, path: str, fv) -> dict[int, tuple[int, str]]:
        """Quarantined pages of ``path`` *as parsed into this exact
        footer object*: ``{page: (group, reason)}``. Entries recorded
        against a different (stale) footer are dropped."""
        with self._lock:
            ent = self._shards.get(path)
            if ent is None:
                return {}
            if ent["footer"] is not fv:
                del self._shards[path]
                return {}
            return dict(ent["pages"])

    def contains(self, path: str, fv, page: int) -> bool:
        return page in self.lookup(path, fv)

    def clear(self, path: Optional[str] = None) -> None:
        with self._lock:
            if path is None:
                self._shards.clear()
            else:
                self._shards.pop(path, None)

    def summary(self) -> dict:
        """Machine-readable snapshot for ``stats()`` / dashboards."""
        with self._lock:
            shards = {
                path: [{"group": g, "page": p, "reason": r}
                       for p, (g, r) in sorted(ent["pages"].items())]
                for path, ent in sorted(self._shards.items())
            }
        return {
            "quarantined_pages": sum(len(v) for v in shards.values()),
            "quarantined_shards": shards,
        }


QUARANTINE = QuarantineRegistry()


# ---------------------------------------------------------------------------
# decode-time verification
# ---------------------------------------------------------------------------

def _verified_memo(fv) -> set:
    """Sample-mode memo: pages already verified against this footer
    object. Rides the FooterView so the process-wide footer cache shares
    it across readers; a set-add race double-verifies at worst."""
    memo = getattr(fv, "_verified_pages", None)
    if memo is None:
        memo = fv._verified_pages = set()
    return memo


def _quarantine(reader, fv, page: int, reason: str) -> ShardCorruptError:
    group = page_group(fv, page)
    if QUARANTINE.add(reader.path, fv, group, page, reason):
        _metrics.counter("bullion.integrity.pages_quarantined").inc()
    # drop the cached footer: the next open re-reads and revalidates, so an
    # out-of-band repair is picked up without a restart
    notify_footer_rewrite(reader.path)
    return ShardCorruptError(reader.path, reason, group=group, page=page)


def verify_pages(reader, raw: dict) -> dict:
    """Verify a ``{page: bytes}`` batch against ``Sec.PAGE_CHECKSUM``.

    Called by the reader after materializing page bytes and before any
    decode. Returns the dict (possibly with recovered bytes swapped in);
    under policy ``mask`` corrupt pages are *removed* and the decoder
    zero-fills them. Raises ``ShardCorruptError`` for corrupt pages under
    ``raise``/``skip`` (the executor turns ``skip`` into page exclusion
    with exact degraded-row accounting)."""
    fv = reader.footer
    policy = verify_policy()
    if not raw or policy == VERIFY_OFF or not fv.has(Sec.PAGE_CHECKSUM):
        return raw
    # remote bodies are the dominant corruption source: always verify fully
    memo = None if (policy == VERIFY_FULL or reader._remote) \
        else _verified_memo(fv)
    cksums = fv.arr(Sec.PAGE_CHECKSUM, np.uint64)
    quarantined = QUARANTINE.lookup(reader.path, fv)
    on_corrupt = corruption_policy()
    verified = failures = quarantines = 0
    drop: list[int] = []
    try:
        for p in sorted(raw):
            if quarantined and p in quarantined:
                group, reason = quarantined[p]
                if on_corrupt == ON_CORRUPT_MASK:
                    drop.append(p)
                    continue
                raise ShardCorruptError(reader.path, reason,
                                        group=group, page=p)
            if memo is not None and p in memo:
                continue
            want = int(cksums[p])
            verified += 1
            if page_hash(raw[p]) == want:
                if memo is not None:
                    memo.add(p)
                continue
            # one direct re-read outside the coalesced run before declaring
            # corruption: recovers transient faults (torn cache, truncated
            # response body) without quarantining the page
            failures += 1
            _metrics.counter("bullion.integrity.checksum_failures").inc()
            off, size = fv.page_extent(p)
            try:
                fresh = reader._pread(off, size)
            except OSError:
                fresh = b""
            verified += 1
            if page_hash(fresh) == want:
                raw[p] = fresh
                if memo is not None:
                    memo.add(p)
                _metrics.counter("bullion.integrity.reread_recovered").inc()
                continue
            quarantines += 1
            err = _quarantine(
                reader, fv, p,
                "page checksum mismatch (persisted across one re-read)")
            if on_corrupt == ON_CORRUPT_MASK:
                drop.append(p)
                continue
            raise err
    finally:
        if verified or failures or quarantines:
            with reader._stats_lock:
                st = reader.stats
                st.pages_verified += verified
                st.checksum_failures += failures
                st.pages_quarantined += quarantines
    for p in drop:
        raw.pop(p, None)
    return raw
