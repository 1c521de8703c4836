"""
Shared matplotlib axis styling (reference:
``mdproptools/utilities/plots.py:12-41``): minor locators, {:g} tick
formatting, inward ticks. matplotlib is imported on use, so the
package itself needs none.
"""


def set_axis(ax, axis="both"):
    import matplotlib.ticker as ticker
    from matplotlib.ticker import AutoMinorLocator

    fmt = ticker.FuncFormatter(lambda v, _: "{:g}".format(v))
    # AutoMinorLocator is linear-scale only (matplotlib warns and
    # ignores it on log axes — the reference trips this on msd_log.png);
    # log axes keep their LogLocator minors.
    if axis in ("both", "x"):
        if ax.xaxis.get_scale() == "linear":
            ax.xaxis.set_minor_locator(AutoMinorLocator(2))
        ax.xaxis.set_major_formatter(fmt)
    if axis in ("both", "y"):
        if ax.yaxis.get_scale() == "linear":
            ax.yaxis.set_minor_locator(AutoMinorLocator(2))
        ax.yaxis.set_major_formatter(fmt)
    ax.tick_params(which="major", length=8)
    ax.tick_params(which="minor", length=4)
    ax.tick_params(
        axis=axis if axis != "both" else "both",
        which="both",
        direction="in",
        labelsize=20,
    )
