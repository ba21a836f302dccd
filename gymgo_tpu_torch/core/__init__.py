from gymgo_tpu_torch.core.state import batch_init_state, init_state, resolve_device
from gymgo_tpu_torch.core.step import PlanesState, StepInfo, step_planes, step_states
