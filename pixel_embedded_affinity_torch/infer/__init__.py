from .inference2d import (build_model, fast_affinities, forward_affinities, run_cvppp_test,
                          run_inference_2d, serve_batch, write_cvppp_submission)
from .inference3d import build_tiled_predictor, decode, run_inference_3d
from .export import (export_checkpoint, export_serving, load_artifact, make_serving_fn_2d,
                     make_serving_fn_3d, save_artifact)
