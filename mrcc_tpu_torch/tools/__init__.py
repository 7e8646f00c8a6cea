"""The user tools: the data-preparation scripts, the viz command lines and
the playground demos of the JAX package (``scripts/*.py``,
``playground/play_*.py``), one module each under the script's name, over
the port's functions.

Each module has the script's functions under their names and
``main(argv=None)`` with the script's flags and defaults, and runs as
``python -m mrcc_tpu_torch.tools.<name>``.  ``main`` returns what it
computed (the tests and ``chip_smoke.py`` read it).  The playground tools
run on the card unless ``--device`` says otherwise; the data tools are
numpy and need no device.
"""
