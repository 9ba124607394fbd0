"""The streaming and multi-target runtime (the JAX package's ``stream/``).

- :class:`MultitargetSearch` / :func:`multitarget_search`: one search per
  target over a shared X, run as one fleet (``models/device_search.
  fleet_search``).

The live session (``StreamSession``: row swaps over a resident fleet) and
the drift detector come with the rest of the stream slice (ROADMAP.md, A,
slice 5: stream/).
"""

from .multitarget import MultitargetSearch, multitarget_search

__all__ = ["MultitargetSearch", "multitarget_search"]
