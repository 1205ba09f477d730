"""bayesnf_tpu: a JAX/XLA Bayesian Neural Field framework.

A from-scratch reimplementation of the capabilities of
google/bayesnf (Bayesian Neural Fields for spatiotemporal prediction,
Nature Communications 15:7942, 2024). The public estimator surface mirrors
the reference API (`/root/reference/src/bayesnf/__init__.py:19-23`):

- :class:`BayesianNeuralFieldMAP` — stochastic ensembles of MAP estimates.
- :class:`BayesianNeuralFieldMLE` — stochastic ensembles of MLE estimates.
- :class:`BayesianNeuralFieldVI`  — ensembles of mean-field surrogate
  posteriors fit with variational inference.

Unlike the reference (pure Python + TFP + pmap(vmap)), this framework is
built on a functional parameter-struct model, an explicit
``jax.sharding.Mesh`` with GSPMD-partitioned ensemble/data axes, a
and a self-contained probability library (no TFP dependency). The hot
paths are plain JAX compiled by XLA (on an NVIDIA H100, cuBLAS matmuls and
XLA fusions).
"""

__version__ = '0.1.0'

from bayesnf_tpu import metrics
from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldEstimator
from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldMAP
from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldMLE
from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldVI

__all__ = [
    'BayesianNeuralFieldEstimator',
    'BayesianNeuralFieldMAP',
    'BayesianNeuralFieldMLE',
    'BayesianNeuralFieldVI',
    'metrics',
    '__version__',
]
