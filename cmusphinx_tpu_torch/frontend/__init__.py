from .fe import FE_ARGS, Frontend, FrontendStream
from .feat import FEAT_ARGS, FeatPipeline
