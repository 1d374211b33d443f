"""Recursive update propagation for the stateful facade (``system.py``).

Counterpart of ``tensorflowraytrace_tpu/update.py``.  The trace is
functional (scenes are functions of their parameters), but the reference's
object API is kept for users bringing its scripts over:
``RecursivelyUpdatable.update`` runs its update handles, then its own
``_update``, then its post-update handles, and does nothing while
``frozen``.
"""

from __future__ import annotations


class RecursivelyUpdatable:
    """Base for objects whose state is recomputed on demand.

    Attributes
    ----------
    update_handles : list of callables run before self._update
    post_update_handles : list of callables run after self._update
    frozen : if True, update() does nothing
    recursively_update : if False, the update handles are skipped
    """

    def __init__(self, update_handles=None, post_update_handles=None,
                 recursively_update=True, **kwargs):
        self.frozen = False
        self.recursively_update = recursively_update
        if update_handles is None:
            self.update_handles = list(self._generate_update_handles())
        else:
            self.update_handles = list(update_handles)
        self.post_update_handles = list(post_update_handles or [])

    def _generate_update_handles(self):
        return []

    def _update(self):
        raise NotImplementedError

    def update(self):
        if self.frozen:
            return
        if self.recursively_update:
            for handle in self.update_handles:
                handle()
        self._update()
        for handle in self.post_update_handles:
            handle()

    def forced_update(self):
        """Update even when frozen."""
        frozen = self.frozen
        self.frozen = False
        try:
            self.update()
        finally:
            self.frozen = frozen
