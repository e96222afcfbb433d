from .fe import FE_ARGS, Frontend
from .feat import FEAT_ARGS, FeatPipeline
