"""The filter store under its JAX module path.

``detprocess_tpu/io/filterfile.py`` holds ``FilterData`` and
``check_fs_consistent``; the port keeps them in ``io/filterdata.py``,
and this module gives them under the JAX path, so that
``from detprocess_tpu_torch.io.filterfile import FilterData`` works as
the JAX import does.
"""

from detprocess_tpu_torch.io.filterdata import (  # noqa: F401
    FilterData, check_fs_consistent)
