from .guards import LossWatchdog, NonFiniteLossError
