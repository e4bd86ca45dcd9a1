"""A family's language model, as the harness sees it.

``families/<family>.lm(cfg, get, device)`` returns the object that knows
the LM: its sizes and weight names, the program's page store in that LM's
layout, its kernels and the work of a chunk.  The harness calls only it:

- ``n_init``, ``vocab_size``: the init prompt's length and vocabulary;
- ``ops``: ``{op name: Op}``, every op a roofline is read for
  (``metrics/<op>_roofline.py``);
- ``chunk_work(k)``: ``dict(ops={op name: [counts.Work of each call]},
  lm=counts.Work)``, the LM's part of a 1-frame chunk appended after k
  pages of its video (the ops' calls included in ``lm``);
- ``page_gaps(recs, control=None)``: ``(gaps, control_gaps)``, the worst
  layer's gap of each checked chunk's new page, the program's page against
  the plain reference's, which follows the stream from the program's own
  vision output and earlier pages; with ``control`` (a
  ``reference.precision.Precision``) the reference at that precision
  against the same, else None.  A record (``harness.Run.chunk``) holds the
  chunk's video and frame (``v``, ``k``), its vision output (``flat``) and
  the store it was appended to (``kvs``);
- ``init_gaps(stores, init_ids, control=None)``: ``(gap, control_gap)``,
  the same for the init prompt's pages of each store, the worst.

``qwen2.py`` is the dense Qwen2 of both of today's families.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class Op:
    """An op whose roofline is read: its kernels in the trace are those
    whose names hold one of ``words`` (a combine kernel counted with the
    kernel before it), ``main`` is the kernel each call launches once, and
    ``launches()`` reads the program's launch counter (None where it is
    gone)."""

    words: Tuple[str, ...]
    main: str
    launches: Callable[[], Optional[int]]
