"""Former import name of ``fastpyvectordb_jax``, kept as a deprecated alias.

Importing it, or any submodule under it, gives the ``fastpyvectordb_jax``
modules themselves.  New code imports ``fastpyvectordb_jax``.
"""

import warnings

from fastpyvectordb_jax._alias import install

warnings.warn(f"{__name__} is deprecated; import fastpyvectordb_jax",
              DeprecationWarning, stacklevel=2)
install(__name__)
