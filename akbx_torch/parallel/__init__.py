"""Multi-device paths of the port (port of :mod:`akbx.parallel`) on
``torch.distributed``: ray and target sharding, the ring Huygens schedule,
the sharded train step (:mod:`.sharding`), streamed giant fans
(:mod:`.batching`), the sharded 2D FFT (:mod:`.fft`) and the multi-device
dry run (:mod:`.dryrun`)."""
