"""Challenge submission API (counterpart of carle_tpu/evaluation/submission.py).

Participants subclass :class:`SubmissionAgent` and override ``forward(obs)
-> action``; the scoring harness (``evaluate``) builds the class with
``seed`` and ``device`` keywords and, given a ``params_path``, calls its
``load_state_dict``.  :class:`DemoAgent` itself is the random baseline
(Bernoulli(0.1) toggles), as in the reference.
"""

from __future__ import annotations

from typing import Any

from ..agents import RandomAgent


class DemoAgent(RandomAgent):
    """Random-toggle baseline with the submission surface."""

    def load_state_dict(self, state_dict: Any) -> None:
        """Hook for parameterized submissions; the baseline has no params."""


class SubmissionAgent(DemoAgent):
    """Submission agent: must produce binary toggle actions when called."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
