"""Host-clock milliseconds of one reaction step with its re-derivation
of the dense operands (the call ``engine.runner`` makes every
interval), each call synchronized, on the window's end state."""


def read(ctx):
    fire = ctx.prog.runner._fire_reactions

    def call():
        fire(ctx.spec, ctx.cfg, ctx.state, ctx.seeds["reactions"])
    return ctx.host_ms(call)
