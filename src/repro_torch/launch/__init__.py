"""Launch tooling of the port: the serving and training entry points
(:mod:`.serve`, :mod:`.train`), the scoreboard's (:mod:`.scoreboard`) and
the roofline verdict it prices cells with (:mod:`.roofline`)."""
