"""Device-event milliseconds of one ``engine.bonded_forces.bonded_forces``
call (energies and forces by autograd) on the window's end state."""


def read(ctx):
    prog, st = ctx.prog, ctx.state
    dense = prog.integrate._dense_of(ctx.cfg, st)

    def call():
        prog.bonded_forces.bonded_forces(
            ctx.spec, ctx.cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
            st.angles, st.dihedrals, st.pairs14, dense=dense)
    return ctx.device_ms(call)
