from . import attention_costs, platforms
from .attention_costs import Cost
from .platforms import PLATFORMS

__all__ = ["attention_costs", "platforms", "Cost", "PLATFORMS"]
