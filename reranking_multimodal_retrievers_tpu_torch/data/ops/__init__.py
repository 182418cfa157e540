"""Project data-op transforms. Importing this package registers all functors
(the reference's `src/data_ops/*` role)."""

from . import common  # noqa: F401
from . import generic  # noqa: F401
from . import synthetic_ops  # noqa: F401
from . import m2kr_ops  # noqa: F401
from . import okvqa_ops  # noqa: F401
from . import wikipedia_ops  # noqa: F401
from . import wit_ops  # noqa: F401
from . import infoseek_ops  # noqa: F401
from . import vg_ops  # noqa: F401
from . import distillation_ops  # noqa: F401
from . import feature_ops  # noqa: F401
