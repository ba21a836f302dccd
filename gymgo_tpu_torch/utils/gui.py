"""Interactive pyglet board GUI (counterpart of ``gymgo_tpu.utils.gui``),
what ``GoEnv.render("human")`` opens: a blocking window that returns the
human's chosen action (mouse click -> (x, y) grid intersection, P ->
pass/None, R -> reset, E -> exit/-1), as the reference's ``render('human')``
does.

pyglet is an optional dependency; it is imported inside the function, so
headless environments never touch it.
"""

from __future__ import annotations


from gymgo_tpu_torch import govars
from gymgo_tpu_torch.utils import gui_math


def run_game_window(env):
    """Open the window for ``env`` (a GoEnv) and block until the user acts.

    Returns the chosen action: (row, col) tuple, None for pass, or -1 for
    exit, as the reference's window does.
    """
    import pyglet
    from pyglet.window import key, mouse

    state = env.state()
    size = env.size

    # pyglet 2.1 renamed pyglet.canvas -> pyglet.display and
    # shapes.Line(width=) -> Line(thickness=); support both so the GUI runs
    # on any installed 2.x.
    display_mod = getattr(pyglet, "display", None) or pyglet.canvas
    import inspect
    line_params = inspect.signature(pyglet.shapes.Line.__init__).parameters
    line_thickness = (
        "thickness" if "thickness" in line_params else "width"
    )

    screen = display_mod.get_display().get_default_screen()
    layout = gui_math.board_layout(screen.width, screen.height, size)
    window_width, window_height = layout.window_width, layout.window_height
    window = pyglet.window.Window(window_width, window_height)
    env.window = window
    env.pyglet = pyglet
    env.user_action = None

    cursor = window.get_system_mouse_cursor(window.CURSOR_CROSSHAIR)
    window.set_mouse_cursor(cursor)

    lower_grid_coord = layout.lower_grid_coord
    upper_grid_coord = layout.upper_grid_coord
    delta = layout.delta
    piece_r = layout.piece_r

    def draw_circle(x, y, color, radius, batch, shapes):
        shapes.append(
            pyglet.shapes.Circle(x, y, radius, color=tuple(
                int(c * 255) for c in color), batch=batch)
        )

    @window.event
    def on_draw():
        pyglet.gl.glClearColor(0.7, 0.5, 0.3, 1)
        window.clear()
        batch = pyglet.graphics.Batch()
        keep = []

        # grid lines + coordinate labels
        for i in range(size):
            offset = lower_grid_coord + i * delta
            keep.append(pyglet.shapes.Line(
                lower_grid_coord, offset, upper_grid_coord, offset,
                color=(77, 77, 77), batch=batch,
                **{line_thickness: 3}))
            keep.append(pyglet.shapes.Line(
                offset, lower_grid_coord, offset, upper_grid_coord,
                color=(77, 77, 77), batch=batch,
                **{line_thickness: 3}))
            for (x, y) in ((lower_grid_coord - 20, offset), (offset, lower_grid_coord - 20)):
                keep.append(pyglet.text.Label(
                    str(i), font_name="Courier", font_size=11, x=x, y=y,
                    anchor_x="center", anchor_y="center",
                    color=(0, 0, 0, 255), batch=batch))

        # info panel
        turn_str = "B" if env.turn() == govars.BLACK else "W"
        info = "Turn: {}\nPassed: {}\nGame: {}".format(
            turn_str, env.prev_player_passed(),
            "OVER" if env.game_ended() else "ONGOING")
        keep.append(pyglet.text.Label(
            info, font_name="Helvetica", font_size=11, x=window_width - 20,
            y=window_height - 20, anchor_x="right", anchor_y="top",
            color=(0, 0, 0, 192), batch=batch, width=window_width / 2,
            align="right", multiline=True))
        # the env's own areas: the native engine's, or its device's
        black_area, white_area = env._areas()
        keep.append(pyglet.text.Label(
            "{}B | {}W".format(int(black_area), int(white_area)),
            font_name="Helvetica", font_size=16, x=window_width / 2,
            y=upper_grid_coord + 80, anchor_x="center",
            color=(0, 0, 0, 192), batch=batch, width=window_width,
            align="center"))
        keep.append(pyglet.text.Label(
            "Pass (p) | Reset (r) | Exit (e)", font_name="Helvetica",
            font_size=11, x=20, y=window_height - 20, anchor_y="top",
            batch=batch, multiline=True, width=window_width))
        keep.append(pyglet.text.Label(
            "Go", font_name="Helvetica", font_size=20, bold=True,
            x=window_width / 2, y=window_height - 20, anchor_x="center",
            anchor_y="top", color=(0, 0, 0, 255), batch=batch,
            width=window_width / 2, align="center"))

        # stones: GUI maps board (i, j) -> screen (x, y) transposed, matching
        # the reference (rendering.py:90,96)
        s = env.state_
        for i in range(size):
            for j in range(size):
                x, y = gui_math.stone_screen_pos(i, j, lower_grid_coord, delta)
                if s[govars.BLACK, i, j] == 1:
                    draw_circle(x, y, [0.0588, 0.1804, 0.2471], piece_r, batch, keep)
                elif s[govars.WHITE, i, j] == 1:
                    draw_circle(x, y, [0.9754] * 3, piece_r, batch, keep)
        batch.draw()

    @window.event
    def on_mouse_press(x, y, button, modifiers):
        if button == mouse.LEFT:
            action = gui_math.mouse_to_intersection(x, y, lower_grid_coord, delta)
            try:
                window.close()
                pyglet.app.exit()
                env.user_action = action
            except Exception:
                pass

    @window.event
    def on_key_press(symbol, modifiers):
        if symbol == key.P:
            window.close()
            pyglet.app.exit()
            env.user_action = None
        elif symbol == key.R:
            env.reset()
            window.close()
            pyglet.app.exit()
        elif symbol == key.E:
            window.close()
            pyglet.app.exit()
            env.user_action = -1

    pyglet.app.run()
    return env.user_action
