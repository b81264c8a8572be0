"""Plots of live points, insertion indices, losses, traces and the
sampler's state. Counterpart of ``nessai_tpu/plot.py``.

matplotlib draws with the Agg backend; this module imports it, so it
needs ``matplotlib`` (and uses ``seaborn``'s style where that is
installed). The ``corner`` package is optional: without it the corner
plot is a pair grid.
"""

import logging
from functools import wraps

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from . import config
from .livepoint import live_points_to_array

logger = logging.getLogger(__name__)

__all__ = [
    "nessai_style",
    "sanitise_array",
    "plot_live_points",
    "plot_1d_comparison",
    "plot_indices",
    "plot_loss",
    "plot_trace",
    "plot_histogram",
    "corner_plot",
    "plot_sampler_state",
]


def nessai_style(line_styles: bool = True):
    """Decorator applying the seaborn-based house style unless disabled via
    ``config.plotting.disable_style``."""

    def decorator(func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            if config.plotting.disable_style:
                return func(*args, **kwargs)
            try:
                import seaborn as sns

                with sns.axes_style(config.plotting.sns_style):
                    return func(*args, **kwargs)
            except ImportError:  # pragma: no cover
                return func(*args, **kwargs)

        return wrapper

    return decorator


def sanitise_array(a, a_min=None, a_max=None):
    """Clip an array for plotting (default minimum from
    ``config.plotting.clip_min``)."""
    if a_min is None:
        a_min = config.plotting.clip_min
    return np.clip(a, a_min, a_max)


def _save_or_return(fig, filename):
    if filename is not None:
        fig.savefig(filename, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


@nessai_style()
def plot_live_points(live_points, filename=None, bounds=None, c=None, **kwargs):
    """Corner-style pair plot of live points. Drops all-NaN columns and
    non-finite rows; a constant hue variable is disabled with a warning;
    ``bounds`` adds prior-bound markers on the diagonal."""
    import pandas as pd
    import seaborn as sns

    df = pd.DataFrame(
        {
            n: np.asarray(live_points[n], dtype=float)
            for n in live_points.dtype.names
            if n not in config.livepoints.non_sampling_parameters
        }
    )
    df = df.dropna(axis="columns", how="all")
    df = df[np.isfinite(df).all(1)]
    if df.shape[1] > 10:
        logger.warning("Too many parameters for pair plot; truncating to 10")
        df = df.iloc[:, :10]
    hue = None
    if c is not None and c in live_points.dtype.names:
        vals = np.asarray(live_points[c])[np.asarray(df.index)]
        if np.all(vals == vals[0]):
            logger.warning(
                "Selected hue variable: %s is constant! Disabling.", c
            )
        else:
            df[c] = vals
            hue = c
    g = sns.PairGrid(
        df, corner=True, diag_sharey=False, hue=hue, vars=[
            col for col in df.columns if col != hue
        ]
    )
    g.map_diag(sns.histplot)
    g.map_offdiag(sns.scatterplot, s=2.0)
    if bounds is not None:
        for i, v in enumerate(bounds.values()):
            g.axes[i, i].axvline(v[0], ls=":", alpha=0.5, color="k")
            g.axes[i, i].axvline(v[1], ls=":", alpha=0.5, color="k")
    return _save_or_return(g.figure, filename)


@nessai_style()
def plot_1d_comparison(
    *live_points,
    parameters=None,
    labels=None,
    colours=None,
    bounds=None,
    hist_kwargs=None,
    filename=None,
    convert_to_live_points: bool = False,
):
    """Overlaid 1-D histograms of multiple sample sets.

    Accepts structured live-point arrays, or plain arrays with
    ``convert_to_live_points=True``; validates label/colour list
    lengths; skips all-NaN parameters; ``bounds`` adds prior-bound
    markers.
    """
    if convert_to_live_points:
        live_points = list(live_points)
        if parameters is None:
            parameters = list(range(live_points[0].shape[-1]))
        for i in range(len(live_points)):
            live_points[i] = {
                k: v for k, v in zip(parameters, live_points[i].T)
            }
    elif any(lp.dtype.names is None for lp in live_points):
        raise RuntimeError(
            "Live points are not structured arrays. "
            "Set `convert_to_live_points=True`."
        )
    elif parameters is None:
        parameters = [
            n
            for n in live_points[0].dtype.names
            if n not in config.livepoints.non_sampling_parameters
        ]
    if labels is None:
        labels = [str(i) for i in range(len(live_points))]
    elif len(labels) != len(live_points):
        raise ValueError(
            "Length of labels list must match number of arrays being "
            "plotted."
        )
    if colours is None:
        import seaborn as sns

        colours = sns.color_palette()
        colours = int(np.ceil(len(live_points) / len(colours))) * colours
    elif len(colours) != len(live_points):
        raise ValueError(
            "Length of colours list must match number of arrays being "
            "plotted."
        )
    n = len(parameters)
    fig, axs = plt.subplots(n, 1, figsize=(4, 2 * n), squeeze=False)
    for i, p in enumerate(parameters):
        finite_points = []
        include = []
        for j, lp in enumerate(live_points):
            vals = np.asarray(lp[p], dtype=float)
            if np.isnan(vals).all():
                continue
            idx = np.isfinite(vals)
            if idx.any():
                finite_points.append(vals[idx])
                include.append(j)
        if not include:
            logger.warning("No finite points for %s, skipping.", p)
            continue
        xmin = min(v.min() for v in finite_points)
        xmax = max(v.max() for v in finite_points)
        for j, vals in enumerate(finite_points):
            orig = include[j]
            axs[i, 0].hist(
                vals,
                bins=30,
                histtype="step",
                range=(xmin, xmax),
                density=True,
                label=labels[orig],
                color=colours[orig],
                **(hist_kwargs or {}),
            )
        axs[i, 0].set_xlabel(p)
        if bounds is not None and p in bounds:
            axs[i, 0].axvline(bounds[p][0], ls=":", alpha=0.5, color="k")
            axs[i, 0].axvline(bounds[p][1], ls=":", alpha=0.5, color="k")
    if axs[0, 0].get_legend_handles_labels()[0]:
        axs[0, 0].legend()
    fig.tight_layout()
    return _save_or_return(fig, filename)


@nessai_style()
def plot_indices(
    indices,
    nlive=None,
    filename=None,
    ks_test_mode: str = "D+",
    confidence_intervals=(0.68, 0.95, 0.997),
    plot_breakdown: bool = True,
    n_breakdown: int = 8,
    cmap: str = "viridis",
):
    """Insertion-index uniformity plot: ECDF deviation with binomial
    confidence bands, index histogram and a per-batch CDF breakdown.

    Parameters:
    ``ks_test_mode`` selects the one-sided KS statistic annotated on the
    figure, ``confidence_intervals`` the shaded binomial bands,
    ``plot_breakdown``/``n_breakdown``/``cmap`` the per-batch CDF panel.
    ``nlive=None`` estimates nlive as ``max(indices) + 1``.
    """
    from scipy import stats

    from .utils.indices import compute_indices_ks_test

    indices = np.asarray(indices)
    if not len(indices):
        logger.warning("Not producing indices plot.")
        return None
    if nlive is None:
        logger.warning(
            "Estimating nlive from insertion indices. "
            "The reported p-value may be incorrect."
        )
        nlive = int(np.max(indices)) + 1
    _, p_value = compute_indices_ks_test(indices, nlive, mode=ks_test_mode)

    n_cols = 3 if plot_breakdown else 2
    fig, ax = plt.subplots(
        1, n_cols, figsize=(4 * n_cols, 4), squeeze=False
    )
    n = len(indices)
    x = np.arange(nlive + 1)
    expected = x / nlive
    counts = np.bincount(indices, minlength=nlive)
    ecdf = np.concatenate([[0], np.cumsum(counts) / n])

    # histogram panel with 1-sigma pmf band
    nbins = min(len(np.histogram_bin_edges(indices, "auto")) - 1, 1000)
    ax[0, 0].axhline(1 / nlive, color="k", alpha=0.5, label="pmf")
    sigma = (nbins / n) ** 0.5 / nlive
    ax[0, 0].axhline(
        1 / nlive + sigma, color="k", ls=":", alpha=0.5, label="1-sigma"
    )
    ax[0, 0].axhline(1 / nlive - sigma, color="k", ls=":", alpha=0.5)
    ax[0, 0].hist(
        indices,
        bins=nbins,
        density=True,
        histtype="step",
        range=(0, nlive - 1),
    )
    ax[0, 0].set_xlabel("insertion index")
    ax[0, 0].legend(loc="lower right")

    # ECDF-deviation panel with binomial confidence bands
    ax[0, 1].plot(x, ecdf - expected, label="observed - expected")
    for ci in confidence_intervals:
        bound = (1 - ci) / 2
        upper = stats.binom.ppf(1 - bound, n, expected) / n - expected
        lower = stats.binom.ppf(bound, n, expected) / n - expected
        ax[0, 1].fill_between(
            x, lower, upper, alpha=0.2, color="grey", label=f"{ci:.1%}"
        )
    ax[0, 1].set_xlabel("insertion index")
    ax[0, 1].set_title(f"KS ({ks_test_mode}) p={p_value:.3g}")
    ax[0, 1].legend(loc="lower right")

    if plot_breakdown:
        batches = np.array_split(indices, n_breakdown)
        colours = plt.get_cmap(cmap)(np.linspace(0, 1, n_breakdown))
        for batch, colour in zip(batches, colours):
            c = np.bincount(batch, minlength=nlive)
            batch_ecdf = np.concatenate([[0], np.cumsum(c) / len(batch)])
            ax[0, 2].plot(
                x, batch_ecdf - expected, color=colour, lw=0.75
            )
        ax[0, 2].set_xlabel("insertion index")
        ax[0, 2].set_title(f"per-batch CDF ({n_breakdown} batches)")
    fig.tight_layout()
    return _save_or_return(fig, filename)


@nessai_style()
def plot_loss(epoch, history, filename=None):
    """Training/validation loss curves."""
    fig = plt.figure()
    plt.plot(history["loss"], label="loss")
    plt.plot(history["val_loss"], label="val loss")
    plt.axvline(epoch, ls="--", c="k")
    plt.xlabel("epoch")
    plt.ylabel("negative log-likelihood")
    plt.legend()
    return _save_or_return(fig, filename)


@nessai_style()
def plot_trace(
    log_x,
    nested_samples,
    parameters=None,
    live_points=None,
    log_x_live_points=None,
    labels=None,
    filename=None,
    **kwargs,
):
    """logX vs parameter trace plots, optionally overlaying the current
    live points at their prior volumes."""
    nested_samples = np.asarray(nested_samples)
    if parameters is None:
        parameters = [
            n
            for n in nested_samples.dtype.names
            if n not in config.livepoints.non_sampling_parameters
        ]
    if labels is not None and len(labels) != len(parameters):
        raise RuntimeError(
            f"List of labels is the wrong length ({len(labels)}) for the "
            f"parameters: {parameters}."
        )
    if live_points is not None and log_x_live_points is None:
        raise ValueError(
            "log_x_live_points must be specified when live_points are "
            "provided"
        )
    n = len(parameters)
    fig, axs = plt.subplots(n, 1, figsize=(5, 2 * n), sharex=True, squeeze=False)
    log_x = np.asarray(log_x)[: len(nested_samples)]
    for i, p in enumerate(parameters):
        axs[i, 0].plot(log_x, nested_samples[p][: len(log_x)], ",")
        if live_points is not None:
            axs[i, 0].plot(
                np.asarray(log_x_live_points)[: len(live_points)],
                np.asarray(live_points[p])[: len(log_x_live_points)],
                ",",
                color="C1",
            )
        axs[i, 0].set_ylabel(labels[i] if labels is not None else p)
    axs[-1, 0].set_xlabel("log X")
    axs[-1, 0].invert_xaxis()
    fig.tight_layout()
    if filename is not None:
        try:
            fig.savefig(filename, bbox_inches="tight")
        except ValueError as e:
            logger.warning("Could not save trace plot. Error: %s", e)
        plt.close(fig)
        return None
    return fig


@nessai_style()
def plot_histogram(samples, label=None, filename=None, **kwargs):
    """Histogram of one parameter's samples."""
    fig = plt.figure()
    plt.hist(np.asarray(samples, dtype=float), bins=30, density=True, **kwargs)
    if label:
        plt.xlabel(label)
    return _save_or_return(fig, filename)


@nessai_style()
def corner_plot(
    array,
    parameters=None,
    truths=None,
    labels=None,
    filename=None,
    include=None,
    exclude=None,
    **kwargs,
):
    """Corner plot; uses the ``corner`` package when available, otherwise
    a seaborn pair grid. ``array``/``include``/``exclude`` match the
    upstream signature; ``parameters`` is an
    alias for ``include``. Fields with no dynamic range are dropped."""
    live_points = array
    if include and exclude:
        raise ValueError("Cannot specify both `include` and `exclude`")
    if parameters is None:
        parameters = include
    if exclude:
        parameters = [n for n in live_points.dtype.names if n not in exclude]
    if parameters is None:
        parameters = [
            n
            for n in live_points.dtype.names
            if n not in config.livepoints.non_sampling_parameters
        ]
    if labels is None:
        labels = np.asarray(parameters)
    else:
        labels = np.asarray(labels)
    # drop fields with no dynamic range
    has_range = np.array(
        [
            (not np.isnan(np.asarray(live_points[n], dtype=float)).all())
            and np.nanmin(live_points[n]) != np.nanmax(live_points[n])
            for n in parameters
        ],
        dtype=bool,
    )
    if not has_range.all():
        logger.warning(
            "Some parameters have no dynamic range. Removing: %s",
            [n for n, b in zip(parameters, has_range) if not b],
        )
    parameters = [n for n, b in zip(parameters, has_range) if b]
    if len(labels) != len(parameters):
        labels = labels[has_range]
    if truths is not None:
        if isinstance(truths, dict):
            if include:
                truths = np.array([truths[n] for n in include])
            else:
                truths = np.fromiter(truths.values(), float)
        else:
            truths = np.asarray(truths)
        if len(truths) != len(parameters):
            if not has_range.all():
                truths = truths[has_range]
            else:
                raise ValueError(
                    "Length of truths does not match number of "
                    "parameters being plotted"
                )
    arr = live_points_to_array(live_points, parameters)
    try:
        import corner

        fig = corner.corner(
            arr, labels=list(labels), truths=truths, **kwargs
        )
    except ImportError:
        import pandas as pd
        import seaborn as sns

        df = pd.DataFrame(arr, columns=parameters)
        g = sns.PairGrid(df, corner=True, diag_sharey=False)
        g.map_diag(sns.histplot)
        g.map_offdiag(sns.histplot, bins=30)
        fig = g.figure
    if filename is not None:
        try:
            fig.savefig(filename, bbox_inches="tight")
        except ValueError as e:
            logger.warning("Could not save corner plot. Error: %s", e)
        plt.close(fig)
        return None
    return fig


@nessai_style()
def plot_sampler_state(sampler, filename=None):
    """Multi-panel state plot for the standard sampler."""
    h = sampler.history
    if h is None or not h["iterations"]:
        return None
    its = h["iterations"][: len(h["logZ"])]
    fig, axs = plt.subplots(4, 1, figsize=(8, 10), sharex=True)
    for ci in h.get("checkpoint_iterations", []):
        # checkpoints marked on every panel
        for a in axs:
            a.axvline(ci, ls=":", color="#66ccff")
    axs[0].plot(its, h["logZ"][: len(its)], label="logZ")
    axs[0].set_ylabel("logZ")
    ax2 = axs[0].twinx()
    ax2.plot(its, h["dlogZ"][: len(its)], c="C1", label="dlogZ")
    ax2.set_yscale("log")
    ax2.set_ylabel("dlogZ")
    axs[1].plot(its, h["logLmin"][: len(its)], label="logLmin")
    axs[1].plot(its, h["logLmax"][: len(its)], label="logLmax")
    axs[1].set_ylabel("logL")
    axs[1].legend()
    axs[2].plot(its, h["acceptance"][: len(its)], label="acceptance")
    axs[2].plot(
        its, h["mean_acceptance"][: len(its)], label="block acceptance"
    )
    for it in sampler.training_iterations:
        axs[2].axvline(it, ls="--", c="lightgrey")
    axs[2].set_ylabel("acceptance")
    axs[2].legend()
    if sampler.rolling_p:
        axs[3].plot(
            np.arange(1, len(sampler.rolling_p) + 1) * sampler.nlive,
            sampler.rolling_p,
            "o",
        )
    axs[3].axhline(0.05, ls="--", c="r")
    axs[3].set_ylabel("rolling p-value")
    axs[3].set_xlabel("iteration")
    fig.tight_layout()
    return _save_or_return(fig, filename)
