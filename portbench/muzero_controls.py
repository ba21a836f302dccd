"""``controls.py`` for the learned-model cells: the program's readings on
``--seeds``, then the float8 control's and each planted fault's
(``muzero_faults.py``) on ``--control-seeds``, each through the harness's
own comparison.

    python3 portbench/muzero_controls.py --workload muzero16.latent_b256 --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--kinds float8,stale_latent,no_scale] [--seconds 3] [--out controls.json]
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench import controls, muzero_faults

    muzero_faults.register()
    controls.PLANTED[muzero_faults.DRIVER] = muzero_faults.OWN
    sys.exit(controls.main())
