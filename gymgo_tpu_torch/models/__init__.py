"""Networks (counterpart of ``gymgo_tpu.models``)."""

from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig, ResBlock, acting_copy, init_params, refresh_
from gymgo_tpu_torch.models.muzero_net import MuZeroNet, MuZeroNetConfig
