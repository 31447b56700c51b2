"""Radix/trie prefix index over completed prompt pages (port of
``repro.serve.prefix``).

Pages are immutable once full — decode only appends to the page holding
position ``seq_len``, past every full prompt page — so prompt prefixes can
be shared through the block table alone. Each trie edge is the byte string
of one page's ``page_size`` token ids; each node owns the pool page holding
that run's K/V codes. A lookup walks the prompt page by page and returns
the longest matched chain, capped at ``(len(prompt) - 1) // page_size``
pages so that at least one prompt token is always prefilled (its logits
give the first generated token).

Ownership is by refcount (:class:`~repro_torch.serve.pages.PageAllocator`):
the trie holds one reference per registered page (taken at
:meth:`PrefixCache.insert`), every sharer one more (:meth:`PrefixCache.use`),
and a node is evictable only while it is a leaf whose page has refcount 1
— no live sequence maps it and no cached prefix extends it.
:meth:`PrefixCache.evict` frees such leaves least recently used first.
The trie never touches device memory except through ``checksum_fn``.
"""
from __future__ import annotations

import itertools

import numpy as np


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used", "checksum")

    def __init__(self, key: bytes, page: int, parent: "_Node | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[bytes, _Node] = {}
        self.last_used = 0
        self.checksum: int | None = None


class PrefixCache:
    """Page-granular prefix index (one per engine). ``checksum_fn(page_id)
    -> int`` over a page's raw code and scale bytes, when set, stamps every
    node at insert and is re-checked at :meth:`use`: a page whose bytes
    changed is dropped with everything cached past it, and the admission
    prefills from there."""

    def __init__(self, page_size: int, allocator, *, checksum_fn=None):
        self.page_size = int(page_size)
        self.allocator = allocator
        self._root = _Node(b"", 0, None)       # sentinel: owns no page
        self._ticks = itertools.count(1)
        self.evictions = 0
        self.checksum_fn = checksum_fn
        self.corrupt_evictions = 0

    def _page_keys(self, prompt, n: int) -> list[bytes]:
        p = self.page_size
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        return [toks[i * p:(i + 1) * p].tobytes() for i in range(n)]

    def _walk(self, prompt) -> list[_Node]:
        """Longest matched node chain, capped so ≥ 1 suffix token remains."""
        n_max = (len(prompt) - 1) // self.page_size
        node, chain = self._root, []
        for key in self._page_keys(prompt, n_max):
            node = node.children.get(key)
            if node is None:
                break
            chain.append(node)
        return chain

    @property
    def n_pages(self) -> int:
        """Pages registered (the references the trie holds)."""
        count, stack = 0, list(self._root.children.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count

    def match(self, prompt) -> list[int]:
        """Matched prefix page ids — a pure read, no refcount change."""
        return [n.page for n in self._walk(prompt)]

    def use(self, prompt) -> list[int]:
        """Match and take one reference per matched page for the caller,
        who frees them like its own (on a failed admission at once).
        Touches the chain's LRU clock."""
        chain = self._walk(prompt)
        if self.checksum_fn is not None:
            for idx, node in enumerate(chain):
                if node.checksum is None or self.checksum_fn(node.page) == node.checksum:
                    continue
                # a corrupt shared page: its descendants attended it when
                # they were minted, so they go too; live sharers keep theirs
                self._drop_subtree(node)
                chain = chain[:idx]
                break
        tick = next(self._ticks)
        for node in chain:
            node.last_used = tick
        pages = [n.page for n in chain]
        self.allocator.incref(pages)
        return pages

    def _drop_subtree(self, node: _Node) -> int:
        """Unlink ``node`` and its descendants, releasing the trie's
        reference on each page."""
        del node.parent.children[node.key]
        dropped, stack = 0, [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.allocator.free([n.page])
            dropped += 1
            self.corrupt_evictions += 1
        return dropped

    def insert(self, prompt, page_ids) -> int:
        """Register a prompt's full pages (``page_ids`` in block-table
        order); returns how many were new (the trie increfs each). Runs
        already cached keep the caller's copy private; the partial tail
        page is never registered."""
        n_full = len(prompt) // self.page_size
        node, fresh = self._root, 0
        tick = next(self._ticks)
        for key, page in zip(self._page_keys(prompt, n_full), page_ids):
            child = node.children.get(key)
            if child is None:
                page = int(page)
                self.allocator.incref([page])
                child = node.children[key] = _Node(key, page, node)
                if self.checksum_fn is not None:
                    child.checksum = self.checksum_fn(page)
                fresh += 1
            child.last_used = tick
            node = child
        return fresh

    def evict(self, n: int = 1) -> int:
        """Free up to ``n`` least recently used leaves that nobody else
        references (refcount exactly 1, the trie's own); returns pages
        freed. Evicting a leaf may expose its parent."""
        freed = 0
        while freed < n:
            victim, stack = None, list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self.allocator.refcount(node.page) == 1:
                    if victim is None or node.last_used < victim.last_used:
                        victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self.allocator.free([victim.page])
            self.evictions += 1
            freed += 1
        return freed

    def release_all(self) -> int:
        """Drop every trie reference and clear the index (drain, or a
        weight-precision flush); returns pages released. In-flight sharers
        keep theirs."""
        released, stack = 0, list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.free([node.page])
            released += 1
        self._root.children.clear()
        return released


__all__ = ["PrefixCache"]
