"""Generative Bayes classifier over state-space component models.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/classifier.py``
(reference semantics: framework_extended/state_space_model_classifier.py:
14-96): one generative component model per label class plus empirical
class propensities; the posterior over classes follows by Bayes rule, in
log space (one logit matrix feeds ``score`` / ``predict_proba`` /
``predict``).  The JAX class derives from scikit-learn's mixins; this one
has no scikit-learn parent (the card's machine has none).  Its components
are built on ``device`` in ``dtype``.
"""

from __future__ import annotations

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    resolve_pair as _resolve_pair,
)


def _as3d(data):
    """Coerce a (states, measurements) pair to 3-D arrays."""
    z, x = data
    return np.atleast_3d(z), np.atleast_3d(x)


class StateSpaceModelClassifier:
    """p(data | class) learned as one state-space model per class."""

    def __init__(self, component_model, *, device=None, dtype=None):
        self.component_model = component_model
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        self.classes = None
        self.n_classes = None
        self.propensities = None
        self.class_models = None
        self.data = None

    def fit(self, data: tuple[np.ndarray, np.ndarray], labels: np.ndarray):
        """Fit one component model per unique label; record empirical
        class propensities (reference classifier:29-44)."""
        z, x = _as3d(data)
        self.data = (z, x)
        labels = np.asarray(labels)
        self.classes, counts = np.unique(labels, return_counts=True)
        self.n_classes = self.classes.size
        self.propensities = counts / counts.sum()
        fitted = []
        for cls in self.classes:
            keep = labels == cls
            fitted.append(
                self.component_model(device=self.device, dtype=self.dtype).fit(
                    data=(z[:, keep], x[:, keep])
                )
            )
        self.class_models = fitted
        return self

    def _resolve(self, data):
        """Default to the training pair; otherwise coerce to 3-D."""
        return _resolve_pair(self.data, data)

    def _logits(self, data) -> np.ndarray:
        """(n, K) matrix of log π_k + log p(data_i | model_k)."""
        cols = []
        for log_pi, mdl in zip(np.log(self.propensities), self.class_models):
            cols.append(log_pi + np.asarray(mdl.score(data=data), float))
        return np.stack(cols, axis=1)

    def score(self, data: tuple[np.ndarray, np.ndarray] = None) -> float:
        """Σ_i log Σ_k π_k p(data_i | k) via logsumexp (reference
        classifier:46-63)."""
        pair = self._resolve(data)
        logits = self._logits(pair)
        assert logits.shape[0] == pair[0].shape[1]
        mx = logits.max(axis=1)
        return float((mx + np.log(np.exp(logits - mx[:, None]).sum(1))).sum())

    def predict_proba(
        self, data: tuple[np.ndarray, np.ndarray] = None
    ) -> np.ndarray:
        """Posterior over classes per instance: softmax of the logits
        (reference classifier:65-83)."""
        pair = self._resolve(data)
        logits = self._logits(pair)
        post = np.exp(logits - logits.max(axis=1, keepdims=True))
        post /= post.sum(axis=1, keepdims=True)
        assert post.shape == (pair[0].shape[1], self.n_classes)
        assert (post >= 0.0).all() and np.allclose(post.sum(axis=1), 1.0)
        return post

    def predict(
        self, data: tuple[np.ndarray, np.ndarray] = None
    ) -> np.ndarray:
        """MAP class label per instance (reference classifier:85-96)."""
        pair = self._resolve(data)
        return self.classes[self.predict_proba(pair).argmax(axis=1)]
