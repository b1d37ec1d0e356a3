"""Viewers (port of ``newton_tpu/viewer``): the logging API every backend
implements (``ViewerBase``), the headless ``ViewerNull``, the recorder
``ViewerFile``, and, loaded at first use, the offline ray-traced
``ViewerRTX`` (through the tiled camera), the ``ViewerUSD`` stage writer,
the matplotlib ``ViewerPlot``, the OpenGL ``ViewerGL`` with its panel, and
the ``ViewerRerun`` and ``ViewerViser`` backends, whose packages are
optional."""

from .viewer import ViewerBase
from .viewer_file import ViewerFile
from .viewer_null import ViewerNull

__all__ = ["ViewerBase", "ViewerFile", "ViewerGL", "ViewerNull",
           "ViewerPlot", "ViewerRerun", "ViewerRTX", "ViewerUSD",
           "ViewerViser"]


def __getattr__(name):
    # the backends with optional dependencies load at first use
    if name == "ViewerGL":
        from .viewer_gl import ViewerGL
        return ViewerGL
    if name == "ViewerRTX":
        from .viewer_rtx import ViewerRTX
        return ViewerRTX
    if name == "ViewerRerun":
        from .viewer_rerun import ViewerRerun
        return ViewerRerun
    if name == "ViewerPlot":
        from .viewer_plot import ViewerPlot
        return ViewerPlot
    if name == "ViewerUSD":
        from .viewer_usd import ViewerUSD
        return ViewerUSD
    if name == "ViewerViser":
        from .viewer_viser import ViewerViser
        return ViewerViser
    raise AttributeError(name)
