"""Abstract component-model interface of the extended framework.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/state_space_model.py``
(reference semantics: framework_extended/state_space_model.py:14-41): a
component model holds an initial-state model, a state-transition model and
a measurement model, is fit on ``(states, observations)`` tuples and
scored per instance.  Subclasses (linear-Gaussian, kNN, hybrid) fill the
three sub-model slots and the data/data-hash bookkeeping.

The JAX class derives from scikit-learn's ``BaseEstimator`` and
``DensityMixin``; the card's machine has no scikit-learn, so this base has
the same slots and no scikit-learn parent.  Nothing in the repository
calls ``get_params``, ``set_params`` or ``clone`` on a component model, so
they are not provided.

Each component takes keyword-only ``device=`` (default the card) and
``dtype=`` for the work it sends to a device.  :meth:`StateSpaceModel.from_state`
and :func:`component_state` carry a trained component across packages as
plain numpy.
"""

from __future__ import annotations

import abc

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.ops.knn import KNNRegressor

# sub-model + bookkeeping slots every component model carries
_COMPONENT_SLOTS = (
    "state_init",
    "state_model",
    "measurement_model",
    "data",
    "data_hash",
)
_SUB_MODELS = ("state_init", "state_model", "measurement_model")


def resolve_pair(default, data):
    """Training pair when ``data`` is None, else the pair coerced 3-D —
    the shared data-resolution idiom of every component model's
    ``score``/``predict`` surface."""
    if data is None:
        return default
    return tuple(map(np.atleast_3d, data))


def _plain(value):
    """A kNN regressor (of either package) as its state dict; anything
    else as it is."""
    return value.__getstate__() if isinstance(getattr(value, "_x", None), np.ndarray) else value


def component_state(model) -> dict:
    """A trained component's sub-models as plain numpy: each kNN regressor
    as ``{"n_neighbors", "_x", "_y", ...}``.  Reads attributes only, so it
    takes the JAX package's components too."""
    return {
        slot: {k: _plain(v) for k, v in getattr(model, slot).items()}
        for slot in _SUB_MODELS
    }


class StateSpaceModel(metaclass=abc.ABCMeta):
    """Abstract base class for a state-space component model."""

    def __init__(self, *, device=None, dtype=None):
        for slot in _COMPONENT_SLOTS:
            setattr(self, slot, None)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)

    def __str__(self):
        return "State space model"

    @classmethod
    def from_state(cls, state: dict, *, device=None, dtype=None, **hyperparams):
        """A trained component from :func:`component_state`'s dict (of
        either package), built with ``hyperparams`` on ``device``."""
        model = cls(**hyperparams, device=device, dtype=dtype)
        for slot in _SUB_MODELS:
            setattr(model, slot, model._restore_block(state[slot]))
        return model

    def _restore_block(self, block: dict) -> dict:
        """A sub-model dict with each kNN regressor (or its state dict)
        rebuilt on this component's device."""
        return {
            k: (
                KNNRegressor.from_state(_plain(v), device=self.device, dtype=self.dtype)
                if isinstance(_plain(v), dict)
                else v
            )
            for k, v in block.items()
        }

    def fit(self, data: tuple[np.ndarray, np.ndarray]):
        """Fit on a ``(states, observations)`` tuple of T×n×dim arrays."""

    def score(self, data: tuple[np.ndarray, np.ndarray]):
        """Per-instance log-likelihoods on a ``(states, observations)``
        tuple."""

    @property
    def n_params(self):
        raise NotImplementedError
