from .mutex import seg_mutex, mws_segmentation
from .merge_small import merge_small_object, merge_func, remove_small_object
from .watershed import (seeded_watershed, get_seeds, watershed_from_affs,
                        distance_transform_watershed)
from .agglomerate import agglomerate
from .multicut import (transform_probabilities_to_costs, rag_mean_affinity,
                       multicut_gaec, mc_baseline)
