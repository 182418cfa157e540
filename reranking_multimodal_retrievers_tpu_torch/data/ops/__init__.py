"""Project data-op transforms. Importing this package registers the ported
functors (the reference's `src/data_ops/*` role); the JAX package's other
data-op modules are not ported yet."""

from . import common  # noqa: F401
from . import generic  # noqa: F401
from . import synthetic_ops  # noqa: F401
from . import m2kr_ops  # noqa: F401
