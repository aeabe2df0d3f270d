from .mutex import seg_mutex, mws_segmentation
from .merge_small import merge_small_object, merge_func, remove_small_object
