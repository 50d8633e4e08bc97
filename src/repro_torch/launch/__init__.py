"""Launch tooling of the port: the serving and training entry points
(:mod:`.serve`, :mod:`.train`), the meshes and the H100's figures
(:mod:`.mesh`), the multi-pod dry-run (:mod:`.dryrun`) with its input
specs (:mod:`.specs`), rule variants (:mod:`.variants`) and record
re-derivation (:mod:`.rederive`), the scoreboard's (:mod:`.scoreboard`)
and the roofline (:mod:`.roofline`)."""
