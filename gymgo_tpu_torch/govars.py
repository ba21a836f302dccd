"""Channel-index constants for the 6-channel Go state.

The state of one game is a ``(NUM_CHNLS, SIZE, SIZE)`` tensor of 0/1 values; a
batch is ``(B, NUM_CHNLS, SIZE, SIZE)``.  TURN/PASS/DONE are whole-plane
indicators.  Same layout as ``gymgo_tpu.govars``, so states move between the
two packages by a dtype cast alone.
"""

ANYONE = None
NOONE = -1

BLACK = 0
WHITE = 1
TURN_CHNL = 2
INVD_CHNL = 3
PASS_CHNL = 4
DONE_CHNL = 5

NUM_CHNLS = 6
