from . import checkpoint
