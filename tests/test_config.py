import math

import pytest

from cracks_tpu.config import Parameters, dump_parameters, load_parameters, parse_prm
from cracks_tpu.expressions import ExpressionError, evaluate
import os
from tests import regression

SNEDDON_PRM = os.path.join(regression.PARAMS_DIR, "parameters_sneddon_2d.prm")


def test_expression_basic():
    assert evaluate("2.0*h", h=0.5) == 1.0
    assert evaluate("1e-8*h", h=2.0) == pytest.approx(2e-8)
    assert evaluate("0 + time *1e3", time=0.01) == pytest.approx(10.0)
    assert evaluate("0.25 * pow(h,0.5)", h=4.0) == pytest.approx(0.5)
    assert evaluate("0.125*pow(h,0.25)", h=16.0) == pytest.approx(0.25)
    assert evaluate("1.0e-3") == 1e-3
    assert evaluate("sqrt(2)") == pytest.approx(math.sqrt(2))


def test_expression_rejects_nasty():
    with pytest.raises(ExpressionError):
        evaluate("__import__('os')")
    with pytest.raises(ExpressionError):
        evaluate("h.denominator", h=2)
    with pytest.raises(ExpressionError):
        evaluate("unknown_var")


def test_parse_prm_text():
    text = """
    subsection Global parameters
      set Max No of timesteps = 3   # comment
      set test case = sneddon
    end
    subsection Solver parameters
      set Use Direct Inner Solver = false
    end
    """
    sections = parse_prm(text)
    assert sections["Global parameters"]["Max No of timesteps"] == "3"
    assert sections["Global parameters"]["test case"] == "sneddon"


def test_comment_stripping_in_value():
    # miehe_tension_adaptive has: set outer solver = active set#simple monolithic
    text = """
    subsection Global parameters
      set outer solver = active set#simple monolithic #active set
    end
    """
    sections = parse_prm(text)
    assert sections["Global parameters"]["outer solver"] == "active set"


def test_load_reference_parameter_file():
    p = load_parameters(SNEDDON_PRM)
    assert p.test_case == "sneddon"
    assert p.outer_solver == "active set"
    assert p.n_local_pre_refine == 2
    assert p.max_no_timesteps == 50
    assert p.n_refinement_cycles == 3
    assert p.G_c == 1.0
    assert p.poisson_ratio_nu == 0.2
    assert p.E_modulus == 1.0
    assert not p.direct_solver
    assert p.lower_bound_newton_residual == 1e-7
    assert p.max_no_newton_steps == 50
    assert p.max_no_line_search_steps == 10
    # expression parameters
    assert p.k_reg(h=1.0) == pytest.approx(1e-8)
    assert p.eps_reg(h=0.5) == pytest.approx(1.0)
    assert p.pressure(time=7.0) == pytest.approx(1e-3)


def test_load_all_reference_test_prms():
    import glob
    for f in sorted(glob.glob(os.path.join(regression.PRM_DIR, "*.prm"))):
        p = load_parameters(f)
        assert p.max_no_timesteps >= 1, f


def test_derived_lame():
    p = Parameters(test_case="sneddon", E_modulus=1.0, poisson_ratio_nu=0.2)
    mu, lam = p.derived_lame
    assert mu == pytest.approx(1.0 / 2.4)
    assert lam == pytest.approx(2 * 0.2 * mu / 0.6)
    p2 = Parameters(test_case="miehe shear", lame_mu=80.77e3, lame_lambda=121.15e3)
    assert p2.derived_lame == (80.77e3, 121.15e3)


def test_gamma_penal_forced_zero_for_active_set():
    p = Parameters(outer_solver="active set", gamma_penal=5.0)
    assert p.effective_gamma_penal == 0.0
    p = Parameters(outer_solver="simple monolithic", gamma_penal=5.0)
    assert p.effective_gamma_penal == 5.0


def test_dump_roundtrip():
    p = load_parameters(SNEDDON_PRM)
    text = dump_parameters(p)
    p2 = load_parameters(text)
    assert p2 == p


def test_direct_inner_solver_honored():
    """`Use Direct Inner Solver = true` must select the direct backend
    (cracks.cc:2750-2758) unless the "TPU parameters" extension overrides it."""
    base = """
subsection Solver parameters
  set Use Direct Inner Solver = true
end
subsection Global parameters
  set Max No of timesteps = 1
end
"""
    p = load_parameters(base)
    assert p.direct_solver is True
    assert p.linear_solver == "direct"
    # an explicit backend choice ("TPU parameters") wins over the
    # reference flag
    p2 = load_parameters(base + """
subsection TPU parameters
  set Linear solver = cg
end
""")
    assert p2.linear_solver == "cg"
    # flag off keeps the auto dispatch
    p3 = load_parameters(base.replace("true", "false"))
    assert p3.linear_solver == "auto"
