"""CLI flags of train_torch.py and test_torch.py (the port's copy of the
root opt.py: the same flags, defaults and help; --platform takes cpu or
cuda, and its default None means the card)."""
import argparse


def get_opts(argv=None):
    parser = argparse.ArgumentParser()

    parser.add_argument('--root_dir', type=str, required=True,
                        help='root directory of dataset')
    parser.add_argument('--dataset_name', type=str, default='nsvf',
                        choices=['nsvf', 'colmap', 'rtmv', 'nerfpp',
                                 'scannet', 'synthetic'],
                        help='which dataset to train/test')
    parser.add_argument('--split', type=str, default='train',
                        choices=['train', 'trainval'],
                        help='use which split to train')
    parser.add_argument('--downsample', type=float, default=1.0,
                        help='downsample factor (<=1.0) for the images')

    parser.add_argument('--scale', type=float, default=0.5,
                        help='scene scale (whole scene must lie in '
                             '[-scale, scale]^3')

    parser.add_argument('--optimize_ext', action='store_true', default=False,
                        help='whether to optimize extrinsics (experimental)')

    parser.add_argument('--batch_size', type=int, default=8192,
                        help='number of rays in a batch')
    parser.add_argument('--num_epochs', type=int, default=30,
                        help='number of training epochs')
    parser.add_argument('--num_gpus', type=int, default=1,
                        help='number of devices (data-parallel mesh size); '
                             '-1 = all')

    parser.add_argument('--eval_lpips', action='store_true', default=False,
                        help='evaluate lpips metric (needs --lpips_weights)')
    parser.add_argument('--val_only', action='store_true', default=False,
                        help='run only validation (need to provide '
                             'ckpt_path)')
    parser.add_argument('--no_save_test', action='store_true', default=False,
                        help='whether to save test image and video')

    parser.add_argument('--lr', type=float, default=1e-2,
                        help='learning rate')

    parser.add_argument('--exp_name', type=str, default='exp',
                        help='experiment name')
    parser.add_argument('--ckpt_path', type=str, default=None,
                        help='pretrained checkpoint to load (including '
                             'optimizers, etc)')

    parser.add_argument('--test_skip', type=int, default=10,
                        help='skip frames for test -- this links to the '
                             'train/test split folder')
    parser.add_argument('--rot_transpose', action='store_true', default=False,
                        help='Transpose rotation mat')
    parser.add_argument('--scale_flip', action='store_true', default=False,
                        help='Flip y and z axis')
    parser.add_argument('--num_levels', type=int, default=16,
                        help='number of instantngp levels')

    # ---- flags beyond the reference's ----------------------------------
    parser.add_argument('--xyz_encoder', type=str, default='packed',
                        choices=['packed', 'packed2', 'hash', 'freq'],
                        help='xyz encoder: packed-corner hash, paired-level '
                             'packed rows (half the gather rows), hash grid, '
                             'or frequency (the fork\'s current config)')
    parser.add_argument('--depth_loss_w', type=float, default=0.0,
                        help='weight of the shift/scale-invariant depth '
                             'prior loss (0 = RGB only)')
    parser.add_argument('--depth_dir', type=str, default=None,
                        help='directory of per-frame monocular depth priors '
                             '(scannet)')
    parser.add_argument('--raw_scan_rootdir', type=str, default=None,
                        help='root of raw ScanNet scans (for the AABB mesh)')
    parser.add_argument('--k_samples', type=int, default=256,
                        help='padded samples per ray in training')
    parser.add_argument('--lpips_weights', type=str, default=None,
                        help='npz with LPIPS-vgg weights')
    parser.add_argument('--bf16', action='store_true', default=False,
                        help='bfloat16 MLP/encoder compute')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--steps_per_epoch', type=int, default=1000,
                        help='iterations per epoch (reference: 1000)')
    parser.add_argument('--grid_size', type=int, default=128,
                        help='occupancy grid resolution per cascade')
    parser.add_argument('--max_samples', type=int, default=1024,
                        help='marching budget per ray (reference: 1024)')
    parser.add_argument('--log2_hashmap_size', type=int, default=19)
    parser.add_argument('--packed_levels', type=int, default=8,
                        help='levels of the packed-corner hash encoder')
    parser.add_argument('--packed_log2_size', type=int, default=16,
                        help='log2 cells per level (packed encoder)')
    parser.add_argument('--random_bg', action='store_true', default=False,
                        help='train against random background colors when '
                             'the dataset provides per-ray alpha')
    parser.add_argument('--random_bg_per_batch', action='store_true',
                        default=False,
                        help='one random bg color per batch instead of the '
                             'default per-ray colors')
    parser.add_argument('--march', type=str, default='seg',
                        choices=['seg', 'block', 'block2', 'dense'],
                        help='training marcher: "seg" (two/three-phase '
                             'segment), "block" (one-phase 8^3 block rows, '
                             'single-cascade only), "block2" (two-phase: '
                             'tiny-table super liveness + stride-4 block '
                             'rows, single-cascade only), "dense" '
                             '(candidate lattice)')
    parser.add_argument('--block_group', type=int, default=0,
                        help='march=block: candidates per block row '
                             '(0 = auto max)')
    parser.add_argument('--n_keep_groups', type=int, default=0,
                        help='march=block: live groups kept per ray '
                             '(0 = k_samples/group)')
    parser.add_argument('--n_keep', type=int, default=32,
                        help='live segments kept per ray by the segment '
                             'marcher (capacity = n_keep*8 candidates)')
    parser.add_argument('--n_keep_sup', type=int, default=24,
                        help='live super-segments kept (3-phase march)')
    parser.add_argument('--exclude_incomplete', type=str, default='backfill',
                        choices=['none', 'hard', 'floor', 'backfill'],
                        help='drop rays whose march truncated content before '
                             'transmittance converged (see models/rendering)')
    parser.add_argument('--platform', type=str, default=None,
                        choices=[None, 'cpu', 'cuda'],
                        help='device to run on (default: the CUDA card; '
                             'without one, only --platform cpu runs)')
    parser.add_argument('--log_dir', type=str, default=None,
                        help='scalar-log dir (JSONL + TensorBoard when '
                             'torch.utils.tensorboard imports); default '
                             'results/<dataset>/<exp>/logs')
    parser.add_argument('--profile_steps', type=int, default=0,
                        help='capture a torch.profiler trace over this '
                             'many steps after warmup (0 = off)')
    parser.add_argument('--debug_nans', action='store_true', default=False,
                        help='enable torch.autograd anomaly detection')
    parser.add_argument('--renderer', choices=['fast', 'oneshot', 'brick',
                                               'brick_mxu'],
                        default='oneshot',
                        help='test.py renderer: "oneshot" = single train-'
                             'style march + straggler re-passes, '
                             '"fast" = while-loop alive-bucket renderer, '
                             '"brick" = tile-rasterized baked-brick serving '
                             'renderer (implies --bake; bounded scenes), '
                             '"brick_mxu" = brick raster with the hand-'
                             'written tile field kernels (implies --bake)')
    parser.add_argument('--brick_mxu_L', type=int, default=192,
                        help='brick_mxu renderer: cull-list candidates '
                             'per tile (wide; the exact hit filter '
                             'compacts to --brick_mxu_exact_cull slots)')
    parser.add_argument('--brick_mxu_kernel', default='tp',
                        choices=['t', 'n', 'tp', 'wl'],
                        help='brick_mxu field kernel layout: "tp" = '
                             'transposed with P list slots batched per '
                             'grid step, "wl" = global-worklist grid '
                             '(round-5 champion: only real (tile, '
                             'P-group) items sequence; see '
                             '--brick_mxu_wl_cap), "t" = rays-on-lanes '
                             'transposed, "n" = samples-on-sublanes')
    parser.add_argument('--brick_mxu_wl_cap', type=int, default=5120,
                        help='brick_mxu kernel=wl: worklist groups per '
                             'list segment across the whole frame.  Must '
                             'cover the true per-segment group load '
                             '(starved groups drop whole trailing tiles '
                             'into the drain); SMEM caps cap*(4+P)*4 '
                             'bytes at ~800 KB.  DESIGN_NOTES R5.4/R5.5')
    parser.add_argument('--T_threshold', type=float, default=1e-2,
                        help='test renderers: terminate rays when '
                             'transmittance falls below this (1e-3 = '
                             '+0.5 dB, ~-8%% FPS on the wl champion)')
    parser.add_argument('--brick_mxu_pbatch', type=int, default=8,
                        help='brick_mxu kernel=tp: list slots rendered '
                             'per grid step (P slab DMAs per step)')
    parser.add_argument('--brick_mxu_exact_cull', type=int, default=48,
                        help='brick_mxu: re-test the wide cull list '
                             'per-ray and compact to this many TRUE-hit '
                             'slots before the kernel runs (eps-free; '
                             '0 disables).  DESIGN_NOTES R4.2/R4.4')
    parser.add_argument('--brick_mxu_seg', type=int, default=8,
                        help='brick_mxu kernel=tp: render lists in '
                             'segments of this many slots; saturated '
                             'tiles stop issuing slab DMAs between '
                             'segments (0 disables)')
    parser.add_argument('--brick_mxu_drain_xc', type=int, default=96,
                        help='brick_mxu: exact-filter drain lists to '
                             'this many true-hit slots (0 = render the '
                             'full drain_L rebuild)')
    parser.add_argument('--brick_mxu_bands', type=int, default=1,
                        help='brick_mxu: 1 = occupancy-banded tile '
                             'scheduling (tiles argsorted by brick-list '
                             'length; empty list slots cost no grid '
                             'steps), 0 = flat (T, L) grid')
    parser.add_argument('--brick_mxu_drain', type=int, default=256,
                        help='brick_mxu: max tiles per chunk re-rendered '
                             'exactly through extended lists when their '
                             'true brick count exceeds the band/list '
                             'capacity (0 disables the overflow drain; '
                             'pairs_undrained telemetry counts any '
                             'remaining culled content)')
    parser.add_argument('--brick_L', type=int, default=256,
                        help='brick renderer: bricks kept per tile list')
    parser.add_argument('--brick_Lk', type=int, default=24,
                        help='brick renderer: brick windows kept per ray')
    parser.add_argument('--brick_ppr', type=float, default=0.0,
                        help='brick renderer: packed pairs budget per ray; '
                             '0 (default) auto-calibrates from pose 0\'s '
                             'true window count (one extra compile) — set '
                             'explicitly for benchmarking')
    parser.add_argument('--synthetic_style', default='solid',
                        choices=['solid', 'shell', 'textured'],
                        help='procedural synthetic dataset variant: '
                             'solid blobs, thin shells (realistic '
                             'samples/ray), or textured shells (high-'
                             'frequency detail - honest encoder-'
                             'capacity tests)')
    parser.add_argument('--brick_drain', type=float, default=0.25,
                        help='brick renderer: drain-pass packing budget '
                             'as a fraction of the ray count (pairs '
                             'left after --brick_passes)')
    parser.add_argument('--brick_macro', type=int, default=8,
                        help='brick renderer: tiles per macro-cull group '
                             '(hierarchical cone cull; 0 = single-level)')
    parser.add_argument('--brick_macro_L', type=int, default=1024,
                        help='brick renderer: candidate bricks kept per '
                             'macro group before per-tile refinement')
    parser.add_argument('--brick_passes', type=float, nargs='*',
                        default=None,
                        help='brick renderer: per-pass packing budgets as '
                             'fractions of the ray count (e.g. 0.5 0.35 '
                             '0.25) — enables sequential early-termination '
                             'passes; default single packed pass')
    parser.add_argument('--render_max_samples', type=int, default=512,
                        help='test-time candidate-lattice resolution for '
                             'the oneshot renderer.  512 measured ~lossless '
                             'vs 1024 on the procedural scene (45.9 dB vs '
                             'live 47.9) and renders strictly faster; 1024 '
                             'needs more straggler passes than the default '
                             'budget and under-renders dense content')
    parser.add_argument('--oneshot_k', type=int, default=32,
                        help='oneshot renderer: samples per ray per pass')
    parser.add_argument('--oneshot_budget_div', type=int, default=0,
                        help='oneshot main pass: field budget = '
                             'chunk*k/div with packing sort; 0 = dense '
                             'row-wise pass (no sort)')
    parser.add_argument('--oneshot_straggler_div', type=int, default=8,
                        help='straggler pool size = chunk/div per pass')
    parser.add_argument('--no_oneshot_drain', dest='oneshot_drain',
                        action='store_false', default=True,
                        help='disable the while_loop straggler drain and '
                             'use the fixed --oneshot_passes schedule '
                             '(which starves at high resolution)')
    parser.add_argument('--oneshot_passes', type=int, default=6,
                        help='fixed straggler schedule length when '
                             '--no_oneshot_drain is set')
    parser.add_argument('--oneshot_drain_budget_div', type=int, default=0,
                        help='drain trips: field budget = trip_rays * '
                             'oneshot_k // div (0 = dense padded eval); '
                             'over-budget rays defer to the next trip '
                             '(exact either way)')
    parser.add_argument('--no_oneshot_compact', dest='oneshot_compact',
                        action='store_false', default=True,
                        help='disable the compact main pass (phase-A ray '
                             'culling + drain-only rendering; applies to '
                             '--march block2 serving with drain on)')
    parser.add_argument('--bake', action='store_true', default=False,
                        help='test.py: bake the field to a sparse voxel '
                             'pool and render the baked serving path')
    parser.add_argument('--bake_res', type=int, default=512,
                        help='baked voxel resolution per axis')
    parser.add_argument('--save_bake', type=str, default=None,
                        help='write the baked field to this .npz (the '
                             'deployable serving artifact - bake once, '
                             'serve anywhere)')
    parser.add_argument('--load_bake', type=str, default=None,
                        help='serve a previously saved bake instead of '
                             'baking from the checkpoint')
    parser.add_argument('--bake_dtype', default='bfloat16',
                        choices=['bfloat16', 'float16', 'float8_e4m3fn'],
                        help='baked pool storage dtype; fp8 halves the '
                             'serving gather bytes (the measured cost) '
                             'for a small fidelity cost')
    parser.add_argument('--weight_decay', type=float, default=0.0,
                        help='decoupled L2 on the encoder table (kills '
                             'stale/colliding entries -> fog control)')
    parser.add_argument('--samples_budget', type=int, default=-1,
                        help='max field-network samples per step via '
                             'compaction; -1 = 16*batch_size, 0 = off')
    parser.add_argument('--grid_sample_div', type=int, default=4,
                        help='density-grid update samples G^3/div uniform '
                             '+ as many occupied cells per call '
                             '(reference recipe: 4; 16 measured ~14%% '
                             'faster steps at equal PSNR, DESIGN_NOTES '
                             'R4.3)')
    return parser.parse_args(argv)
