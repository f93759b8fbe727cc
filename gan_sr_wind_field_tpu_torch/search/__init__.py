from gan_sr_wind_field_tpu_torch.search.asha import ASHAScheduler
from gan_sr_wind_field_tpu_torch.search.driver import param_search

__all__ = ["ASHAScheduler", "param_search"]
