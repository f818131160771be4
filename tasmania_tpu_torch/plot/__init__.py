"""Plotting of model states on the host with matplotlib (counterpart of
``tasmania_tpu/plot/``, with the same exports).  matplotlib is imported
only when a figure is drawn, so the package imports where it is absent;
tensor data, also on the card, is copied to host numpy when drawn."""

from tasmania_tpu_torch.plot.drawer import Drawer
from tasmania_tpu_torch.plot.monitors import Plot, PlotComposite
from tasmania_tpu_torch.plot.plot_utils import Animation
from tasmania_tpu_torch.plot.patches import Annotation, Circle, Rectangle, Segment
from tasmania_tpu_torch.plot.retrievers import DataRetriever, DataRetrieverComposite
from tasmania_tpu_torch.plot.drawers import (
    CDF,
    Contour,
    Contourf,
    HovmollerDiagram,
    Line,
    LineProfile,
    Quiver,
    TimeSeries,
)

__all__ = [
    "Drawer",
    "Plot",
    "PlotComposite",
    "Animation",
    "DataRetriever",
    "DataRetrieverComposite",
    "CDF",
    "Contour",
    "Contourf",
    "HovmollerDiagram",
    "Line",
    "LineProfile",
    "Quiver",
    "TimeSeries",
    "Annotation",
    "Circle",
    "Rectangle",
    "Segment",
]
