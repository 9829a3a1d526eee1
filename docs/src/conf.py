# Sphinx configuration for ska-pst-dsp.
# Build (where sphinx is available):  sphinx-build -b html docs/src docs/html
project = "ska-pst-dsp"
author = "ska-pst-dsp developers"
release = "0.2"

extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]
exclude_patterns = []
html_theme = "alabaster"

# kernels import jax at module load; keep autodoc light on doc builders
autodoc_mock_imports = []
