"""gymgo_tpu_torch.utils.gui_math against gymgo_tpu.utils.gui_math at sizes
5-19, and the port's window (``utils.gui.run_game_window``) on a port
``GoEnv`` (torch on the CPU and native) under both generations of the stub
pyglet of ``tests/test_gui_window.py``: a click comes back as the board
action, P / E / R pass, exit and reset, and ``render("human")`` opens it."""

import sys

import numpy as np
import pytest

from gymgo_tpu.utils import gui_math as jgui_math
from gymgo_tpu_torch.env import GoEnv
from gymgo_tpu_torch.utils import gui_math
from test_gui_window import VERSIONS, _Handlers, _make_stub_pyglet

SCREENS = [(1920, 1080), (1280, 1024), (800, 600), (3840, 2160)]


@pytest.mark.parametrize("size", range(5, 20))
def test_gui_math_matches_jax(size):
    for screen in SCREENS:
        lay = gui_math.board_layout(*screen, size)
        want = jgui_math.board_layout(*screen, size)
        assert tuple(lay) == tuple(want) and lay._fields == want._fields
        assert gui_math.grid_line_offsets(size, lay.lower_grid_coord, lay.delta) == \
            jgui_math.grid_line_offsets(size, want.lower_grid_coord, want.delta)
        for i in range(size):
            for j in range(size):
                pos = gui_math.stone_screen_pos(i, j, lay.lower_grid_coord, lay.delta)
                assert pos == jgui_math.stone_screen_pos(i, j, lay.lower_grid_coord, lay.delta)
                assert gui_math.mouse_to_intersection(*pos, lay.lower_grid_coord, lay.delta) == (i, j)
        rng = np.random.default_rng(size)
        for x, y in rng.uniform(-50, screen[0], size=(50, 2)):
            assert gui_math.mouse_to_intersection(x, y, lay.lower_grid_coord, lay.delta) == \
                jgui_math.mouse_to_intersection(x, y, lay.lower_grid_coord, lay.delta)


@pytest.fixture(params=["torch", "native"])
def midgame_env(request):
    kw = {"device": "cpu"} if request.param == "torch" else {}
    env = GoEnv(size=7, backend=request.param, **kw)
    assert env.backend == request.param
    env.reset()
    for mv in [(3, 3), (2, 2), (3, 4), (2, 3), (1, 1)]:
        env.step(mv)
    return env


def _install(monkeypatch, script, version):
    handlers = _Handlers()
    pyglet, mods = _make_stub_pyglet(handlers, script, version)
    monkeypatch.setitem(sys.modules, "pyglet.canvas", None)
    monkeypatch.setitem(sys.modules, "pyglet.display", None)
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return pyglet


def _run_gui(monkeypatch, env, script, version):
    pyglet = _install(monkeypatch, script, version)
    from gymgo_tpu_torch.utils import gui

    return gui.run_game_window(env), pyglet._drawn


@pytest.mark.parametrize("version", VERSIONS)
def test_click_returns_board_action(monkeypatch, midgame_env, version):
    size = midgame_env.size
    lay = gui_math.board_layout(1920, 1080, size)

    def script(handlers):
        x, y = gui_math.stone_screen_pos(4, 5, lay.lower_grid_coord, lay.delta)
        handlers.fns["on_mouse_press"](x, y, 1, 0)  # mouse.LEFT

    action, drawn = _run_gui(monkeypatch, midgame_env, script, version)
    assert tuple(np.asarray(action)) == (4, 5)
    # the draw pass really ran: grid lines, 5 stones, labels, batch.draw
    assert drawn["batches"] == 1
    assert drawn["shapes"] == 2 * size + 5
    assert drawn["labels"] == 2 * size + 4
    # the returned action steps the env where the click was
    midgame_env.step(action)
    assert midgame_env.state()[1, 4, 5] == 1


@pytest.mark.parametrize("version", VERSIONS)
def test_pass_reset_exit_keys(monkeypatch, midgame_env, version):
    def press(sym):
        def script(handlers):
            handlers.fns["on_key_press"](sym, 0)

        return script

    action, _ = _run_gui(monkeypatch, midgame_env, press(112), version)  # P
    assert action is None
    action, _ = _run_gui(monkeypatch, midgame_env, press(101), version)  # E
    assert action == -1
    assert int(np.sum(midgame_env.state()[[0, 1]])) == 5
    _run_gui(monkeypatch, midgame_env, press(114), version)  # R
    assert int(np.sum(midgame_env.state()[[0, 1]])) == 0


@pytest.mark.parametrize("version", VERSIONS)
def test_render_human_opens_the_window(monkeypatch, midgame_env, version):
    clicked = []

    def script(h):
        clicked.append(True)
        h.fns["on_key_press"](112, 0)  # P -> pass

    _install(monkeypatch, script, version)
    assert midgame_env.render("human") is None
    assert clicked and midgame_env.window.closed
    midgame_env.close()


def test_render_human_without_pyglet_raises_import_error(monkeypatch, midgame_env):
    monkeypatch.setitem(sys.modules, "pyglet", None)
    with pytest.raises(ImportError):
        midgame_env.render("human")
