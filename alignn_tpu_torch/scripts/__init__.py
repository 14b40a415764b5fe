"""Campaign scripts (counterpart of ``alignn_tpu/scripts/``).

The framework's science and training workflows as thin command-line
programs: E-V curves, cubic relaxations, vacancies, phonon plots,
predictions over databases, per-property training campaigns and the
mlearn force-field campaign.  Each keeps the JAX script's ``main(argv)``,
arguments and outputs; a script that builds a model takes ``--device``
(``cuda`` by default, ``cpu`` on request).
"""
