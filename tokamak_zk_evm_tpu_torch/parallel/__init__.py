"""The multi-device path: the prover across the ranks of a process group
(torch.distributed; NCCL between cards, gloo on the CPU).

Every rank runs the whole prover.  Under `context.use_mesh(mesh)` the two
heavy ops share their work across the mesh: `ops.ntt.bintt` through
`ntt_dist.bintt_dist` and `ops.msm.msm_start` through `msm_dist.msm_dist`;
every other op runs on each rank's replicated tensors.  The proof is the
unsharded one, byte for byte.
"""
