"""Offline analysis and visualization suite (port of ``mrcc_tpu/viz``,
after the reference's ``visualization/``).

Headless matplotlib pictures and TSV exports (the Open3D viewers need a
display); every function writes files and returns the computed data.
``matplotlib`` is imported only where a picture is drawn, so the package
imports without it.
"""

from .analysis import (  # noqa: F401
    confidence_plots,
    embedding_export,
    error_histograms,
)
from .html_viewer import write_html_viewer  # noqa: F401
