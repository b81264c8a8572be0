#!/usr/bin/env python
"""A corner plot of a run's posterior samples: the 2-D unit normal on
[-10, 10]^2 (host likelihood), run without the sampler's own plots, then
:func:`nessai_tpu_torch.plot.corner_plot` with the true values marked.
Without the ``corner`` package the plot is a seaborn pair grid.

Counterpart of ``examples/corner_plot_example.py``; the model is
:class:`nessai_tpu_torch.utils.testing.GaussianModel` (the same model as
the MCMC example's). Analytic log-evidence: ``-log 400``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.corner_plot_example``.
"""

import os

from ..utils.testing import GaussianModel

OUTPUT = "./outdir/corner_plot/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234)
#: the script's arguments of ``run``
RUN_KWARGS = dict(plot=False)
#: the true values the plot marks
TRUTHS = [0.0, 0.0]

__all__ = ["GaussianModel", "OUTPUT", "RUN_KWARGS", "SAMPLER_KWARGS", "TRUTHS", "plot_posterior"]


def plot_posterior(fs, output: str = OUTPUT) -> str:
    """The corner plot of ``fs``'s posterior samples, written to
    ``output/corner.png``; returns the file's path."""
    from ..plot import corner_plot

    filename = os.path.join(output, "corner.png")
    corner_plot(fs.posterior_samples, truths=TRUTHS, filename=filename)
    return filename


if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    fs = FlowSampler(GaussianModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS)
    fs.run(**RUN_KWARGS)
    plot_posterior(fs)
