"""Scene presets replicating the reference's hardcoded scenes.

The reference has no scene files; its "API" is C++ construction code in
ui/RenderThread.cpp:46-187 + ui/ModelList.cpp.  These builders replicate
that geometry verbatim (coordinates from ModelList.cpp:71-147, materials
from RenderThread.cpp:78-103) so parity tests compare like for like, plus
the five BASELINE.md configs.
"""

import numpy as np

from .camera import make_perspective_camera
from .scene import SceneBuilder

# Cornell wall vertices (ModelList.cpp:83-100), 10 triangles, before the
# translate by -2.5 (tri_ConBox2World, ModelList.cpp:101)
_L = 5.0
CORNELL_VERTS = np.array([
    # floor
    [0, 0, _L], [_L, 0, _L], [0, 0, 0],
    [_L, 0, _L], [_L, 0, 0], [0, 0, 0],
    # ceiling
    [0, _L, _L], [0, _L, 0], [_L, _L, _L],
    [_L, _L, _L], [0, _L, 0], [_L, _L, 0],
    # back wall
    [0, 0, 0], [_L, 0, 0], [_L, _L, 0],
    [0, 0, 0], [_L, _L, 0], [0, _L, 0],
    # right wall (x=0 side; gets material1 = red in the reference call)
    [0, 0, 0], [0, _L, _L], [0, 0, _L],
    [0, 0, 0], [0, _L, 0], [0, _L, _L],
    # left wall (x=L side; material2 = blue)
    [_L, 0, 0], [_L, _L, _L], [_L, 0, _L],
    [_L, 0, 0], [_L, _L, 0], [_L, _L, _L],
], np.float32)

# Area light quad (ModelList.cpp:128-129), translated by (0, 2.45, 0)
AREA_LIGHT_VERTS = np.array([
    [-1.4, 0.0, 1.4], [-1.4, 0.0, -1.4], [1.4, 0.0, 1.4],
    [1.4, 0.0, 1.4], [-1.4, 0.0, -1.4], [1.4, 0.0, -1.4],
], np.float32)


def _translate(v):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = v
    return m


def add_cornell(b: SceneBuilder, mat_red, mat_blue, mat_white):
    """AddCornell (ModelList.cpp:71-119): tris 6,7 -> material1 (red wall),
    tris 8,9 -> material2 (blue wall), rest -> material3 (white)."""
    tris = np.arange(30).reshape(10, 3)
    xf = _translate([-0.5 * _L, -0.5 * _L, -0.5 * _L])
    mats = [mat_white] * 6 + [mat_red] * 2 + [mat_blue] * 2
    # add per-material groups preserving triangle order
    start, _ = b.add_mesh(CORNELL_VERTS, tris, mat_white, transform=xf)
    # patch per-tri materials (builder stores per-mesh; easiest: set directly)
    import numpy as _np
    b.tri_mat[-1] = _np.asarray(mats, _np.int32)
    return start


def add_area_lights(b: SceneBuilder, mat_light, l_emit=(5.0, 5.0, 5.0)):
    """AddAreaLight (ModelList.cpp:121-147): 2 emissive triangles at
    y=2.45, each its own DiffuseAreaLight with Lemit=5."""
    xf = _translate([0.0, 2.45, 0.0])
    start, n = b.add_mesh(AREA_LIGHT_VERTS, np.arange(6).reshape(2, 3),
                          mat_light, transform=xf)
    ids = []
    for i in range(n):
        lid = b.add_area_light_tri(start + i, l_emit, two_sided=False)
        ids.append(lid)
    # tag the triangles with their light ids
    import numpy as _np
    b.tri_light[-1] = _np.asarray(ids, _np.int32)
    return ids


def reference_materials(b: SceneBuilder, sigma=60.0):
    """RenderThread.cpp:78-103 material set (note sigma=60 -> Oren-Nayar)."""
    white = b.add_matte((0.91, 0.91, 0.91), sigma=sigma)
    dragon = b.add_matte((0.2, 0.8, 0.2), sigma=sigma)
    red = b.add_matte((0.9, 0.1, 0.17), sigma=sigma)
    blue = b.add_matte((0.14, 0.21, 0.87), sigma=sigma)
    mirror = b.add_mirror((0.2, 0.8, 0.2))
    return dict(white=white, dragon=dragon, red=red, blue=blue, mirror=mirror)


def cornell_box(width=500, height=500, sigma=60.0, skybox=True,
                dragon_material=None, bvh=False, mesh=None, mesh_transform=None):
    """The reference default scene minus the (missing) dragon mesh:
    Cornell box + 2-triangle area light + SkyBoxLight, camera at
    (0,0,5) looking at origin, fov 90 (RenderThread.cpp:52-68).

    mesh: optional (vertices, triangles) to place like AddModel does
    (translate (0,-2.9,0), ModelList.cpp:56).
    """
    b = SceneBuilder()
    mats = reference_materials(b, sigma=sigma)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])  # reference passes dragonMaterial
    if mesh is not None:
        v, t = mesh
        xf = mesh_transform if mesh_transform is not None else _translate([0.0, -2.9, 0.0])
        mat = dragon_material if dragon_material is not None else mats["dragon"]
        b.add_mesh(v, t, mat, transform=xf)
    if skybox:
        b.add_skybox_light()
    scene = b.build(bvh=bvh)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return scene, cam


def cornell_glass(width=500, height=500):
    """BASELINE config 3: Cornell with Glass / Mirror / Disney objects."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=60.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    glass = b.add_glass(eta=1.5)
    disney = b.add_disney((0.7, 0.3, 0.2), rough_u=0.3, metallic=0.4,
                          clearcoat=1.0, sheen=0.5)
    b.add_sphere((-1.3, -1.6, 0.2), 0.9, glass)
    b.add_sphere((1.3, -1.6, -0.5), 0.9, mats["mirror"])
    b.add_sphere((0.0, -1.8, 1.2), 0.7, disney)
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


def cornell_gmd(width=500, height=500, sigma=0.0):
    """Parity twin of the oracle's `gmd` scene (BASELINE config 3):
    Cornell + area light + three axis-aligned boxes carrying Glass /
    Mirror / Disney (tools/ref_oracle/oracle_main.cpp `gmd`; reference
    classes materials/GlassMaterial.cpp:14, MirrorMaterial.cpp:13,
    DisneyMaterial.cpp:467-583).  Box literals MUST match the oracle."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=sigma)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    glass = b.add_glass(kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5)
    mirror = b.add_mirror((0.9, 0.9, 0.9))  # the oracle's Kr, not the
    # reference app's green (0.2, 0.8, 0.2) mirror
    disney = b.add_disney((0.7, 0.3, 0.2), metallic=0.4, eta=1.5,
                          rough_u=0.3, rough_v=0.3, specular_tint=0.0,
                          anisotropic=0.0, sheen=0.5, sheen_tint=0.5,
                          clearcoat=1.0, clearcoat_gloss=1.0)
    for lo, hi, mat in (
            ((-1.9, -2.5, -0.3), (-0.7, -1.3, 0.9), glass),
            ((0.6, -2.5, -1.2), (2.0, -0.7, 0.2), mirror),
            ((-0.35, -2.5, 1.0), (0.75, -1.4, 2.1), disney)):
        v, f = _box_mesh(np.asarray(lo), np.asarray(hi))
        b.add_mesh(v, f, mat)
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


def cornell_metal(width=500, height=500):
    """Parity twin of the oracle's `metal` scene: Cornell + area light +
    two boxes carrying the reference app's OWN Metal and Plastic presets —
    getYelloMetalMaterial (ui/MaterialList.cpp:58-69: eta (.2,.2,.8),
    k (.11,.11,.11), rough .15, remapRoughness=false) and
    getPurplePlasticMaterial (ui/MaterialList.cpp:49-56: purple kd,
    kr = 1-kd, rough .1, remap=true).  Box literals MUST match
    tools/ref_oracle/oracle_main.cpp `metal`."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    metal = b.add_metal((0.2, 0.2, 0.8), (0.11, 0.11, 0.11),
                        roughness=0.15, remap_rough=0.0)
    plastic = b.add_plastic((0.35, 0.12, 0.48), ks=(0.65, 0.88, 0.52),
                            roughness=0.1)
    for lo, hi, mat in (
            ((-1.6, -2.5, -0.5), (-0.3, -1.1, 0.7), metal),
            ((0.5, -2.5, -0.9), (1.8, -0.9, 0.4), plastic)):
        v, f = _box_mesh(np.asarray(lo), np.asarray(hi))
        b.add_mesh(v, f, mat)
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


def cornell_homogeneous(width=500, height=500):
    """Parity twin of the oracle's `volpath` scene (BASELINE config 5,
    homogeneous tier): Cornell + area light + a null-material box holding
    HomogeneousMedium(sigma_a=0.25, sigma_s=0.45, g=0.3)
    (media/HomogeneousMedium.cpp:11-43 via
    integrators/VolPathIntegrator.cpp:24-159)."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    hom = b.add_homogeneous_medium((0.25, 0.25, 0.25), (0.45, 0.45, 0.45),
                                   g=0.3)
    v, f = _box_mesh(np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0]))
    b.add_mesh(v, f, material=-1, medium=(hom, -1))
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


def cornell_gridvol(width=500, height=500):
    """Parity twin of the oracle's `gridvol` scene (BASELINE config 5,
    grid tier): Cornell + area light + a null-material box holding a
    GridDensityMedium built from the reference's shipped
    Resources/density_render.70.volume (loaded via loaders.load_volume —
    the reference has no loader, SURVEY.md §2.5).  sigma = file values
    x 0.1 (sigma_a 1, sigma_s 9), g = 0; mediumToWorld maps the unit grid
    cube onto the [-1,-2.4,-1]x[1,-0.4,1] box.  Exercises delta tracking
    (GridDensityMedium::Sample) and ratio-tracking Tr
    (media/GridDensityMedium.cpp:31-87) against the oracle."""
    from .loaders import load_volume

    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    vol = load_volume("/root/reference/Resources/density_render.70.volume")
    m2w = np.eye(4)
    m2w[0, 0] = m2w[1, 1] = m2w[2, 2] = 2.0
    m2w[:3, 3] = [-1.0, -2.4, -1.0]
    grid_med = b.add_grid_medium(vol["density"],
                                 np.asarray(vol["sigma_a"]) * 0.1,
                                 np.asarray(vol["sigma_s"]) * 0.1, g=0.0,
                                 medium_to_world=m2w)
    v, f = _box_mesh(np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0]))
    b.add_mesh(v, f, material=-1, medium=(grid_med, -1))
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


# Seed of the generated environment and floor texture of envmap_mesh.
ENV_SEED = 20260816


def procedural_sky(width=1000, height=500, seed=ENV_SEED):
    """Equirectangular HDR environment (H, W, 3) in the InfiniteAreaLight
    layout (row = theta from the light-space +z pole, column = phi): a sky
    gradient over a dark ground, seeded cloud noise, and a small sun disk
    ~1000x brighter than the sky.  The sun carries ~40% of the
    environment's power in ~0.03% of its texels, so the env CDF's
    importance sampling and the packed le_func path (lights.envmap_le_pdf)
    do real work."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    up = np.cos(th)[..., None]  # 1 at the zenith, 0 at the horizon
    zenith = np.array([0.25, 0.45, 1.0])
    horizon = np.array([0.9, 0.9, 0.95])
    ground = np.array([0.12, 0.1, 0.08])
    sky = np.where(up > 0, horizon + (zenith - horizon) * np.sqrt(
        np.clip(up, 0.0, 1.0)), ground)
    # clouds: seeded coarse noise, bilinearly upsampled, above the horizon
    coarse = rng.random((height // 25 + 2, width // 25 + 2))
    yi = np.linspace(0, coarse.shape[0] - 1.001, height)
    xi = np.linspace(0, coarse.shape[1] - 1.001, width)
    y0, x0 = yi.astype(int), xi.astype(int)
    fy, fx = (yi - y0)[:, None], (xi - x0)[None, :]
    c = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
         + coarse[y0 + 1][:, x0] * fy * (1 - fx)
         + coarse[y0][:, x0 + 1] * (1 - fy) * fx
         + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    cloud = np.clip(c - 0.55, 0.0, None)[..., None] * 2.0 * (up > 0)
    sky = sky * (1.0 - cloud) + cloud
    # sun: angular radius 0.035 rad at theta 0.9, phi 1.0
    sun_dir = np.array([np.sin(0.9) * np.cos(1.0), np.sin(0.9) * np.sin(1.0),
                        np.cos(0.9)])
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1)
    in_sun = (dirs @ sun_dir) > np.cos(0.035)
    sky = np.where(in_sun[..., None], np.array([1000.0, 940.0, 840.0]), sky)
    return sky.astype(np.float32)


def procedural_texture(size=512, seed=ENV_SEED):
    """Linear RGB (size, size, 3) floor texture with detail down to the
    texel: seeded per-cell colours on an 8-texel checker, a one-texel
    grain and thin grid lines, so minified lookups need the EWA filter."""
    rng = np.random.default_rng(seed + 1)
    y, x = np.mgrid[0:size, 0:size]
    cells = rng.uniform(0.15, 0.85, (size // 8, size // 8, 3))
    img = cells[y // 8, x // 8]
    checker = (((x // 8) + (y // 8)) % 2)[..., None]
    img = img * (0.6 + 0.4 * checker)
    img = img * rng.uniform(0.8, 1.0, (size, size, 1))
    lines = ((x % 32) < 1) | ((y % 32) < 1)
    img = np.where(lines[..., None], 0.05, img)
    return img.astype(np.float32)


def envmap_mesh(width=500, height=500, hdr_path=None, mesh=None,
                mesh_tris=104_882, texture_path=None):
    """BASELINE config 4: ~dragon-scale mesh via BVH + ImageTexture +
    InfiniteAreaLight HDR environment (reference AddInfLight,
    ModelList.cpp:172-179, LightToWorld = RotateX(20)*RotateY(-90)*
    RotateX(-90)).  The reference lights it with MonValley1000.hdr and
    textures the floor with awesomeface.jpg; without those paths the
    environment and texture are generated from ENV_SEED
    (procedural_sky, procedural_texture), so the scene is the same on
    every machine."""
    b = SceneBuilder()
    mat = b.add_disney((0.6, 0.5, 0.45), rough_u=0.35, metallic=0.1)
    if mesh is None:
        from .loaders import make_blob_mesh

        n_seg = max(8, int(round((mesh_tris / 2) ** 0.5)))
        v, t, n, uv = make_blob_mesh(n_seg)
        b.add_mesh(v, t, mat, transform=_translate([0.0, -0.5, 0.0]),
                   normals=n, uvs=uv)
    else:
        v, t = mesh
        b.add_mesh(v, t, mat, transform=_translate([0.0, -0.5, 0.0]))
    # textured ground plane (ImageTexture through the MIPMap/EWA path)
    if texture_path is not None:
        from ..utils.image import load_image

        tex_img = load_image(texture_path, gamma=True)
    else:
        tex_img = procedural_texture()
    tex = b.add_texture(tex_img)
    floor_mat = b.add_matte((1.0, 1.0, 1.0), sigma=0.0, kd_tex=tex)
    g = 6.0
    gv = np.array([[-g, -1.7, g], [g, -1.7, g], [-g, -1.7, -g],
                   [g, -1.7, g], [g, -1.7, -g], [-g, -1.7, -g]], np.float32)
    guv = np.array([[0, 0], [4, 0], [0, 4], [4, 0], [4, 4], [0, 4]],
                   np.float32)
    b.add_mesh(gv, np.arange(6).reshape(2, 3), floor_mat, uvs=guv)
    if hdr_path is not None:
        from ..utils.image import load_image

        env_img = load_image(hdr_path)
    else:
        env_img = procedural_sky()
    l2w = _rot_x(20) @ _rot_y(-90) @ _rot_x(-90)
    b.set_environment(env_img, light_to_world=l2w)
    scene = b.build(bvh=True)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.8, 5.0),
                                  look=(0.0, -0.3, 0.0))
    return scene, cam


def envmap_mesh_parity(width=64, height=64, n_seg=50, sigma=0.0):
    """Parity twin of the oracle's `envmesh` scene (BASELINE config 4):
    blob mesh (flat-shaded matte — the .3d format the oracle loads via
    shape/plyRead.h:12-55 carries no normals/uvs) + awesomeface-textured
    floor (textures/ImageTexture.h:42-92) + MonValley InfiniteAreaLight
    (lights/InfiniteAreaLight.cpp:12-121).  ref_warp applies the
    reference's r*sqrt(r) load-time radiance warp
    (InfiniteAreaLight.cpp:41) so both sides integrate the same texels.
    Write the mesh for the oracle with scene/loaders.save_3d."""
    import os

    from .loaders import make_blob_mesh
    from ..utils.image import load_image

    v, t, _n, _uv = make_blob_mesh(n_seg)
    b = SceneBuilder()
    blob = b.add_matte((0.2, 0.8, 0.2), sigma=sigma)
    b.add_mesh(v, t, blob, transform=_translate([0.0, -0.5, 0.0]))
    tex_path = "/root/reference/Resources/awesomeface.jpg"
    assert os.path.exists(tex_path)
    tex = b.add_texture(load_image(tex_path, gamma=True))
    floor_mat = b.add_matte((1.0, 1.0, 1.0), sigma=0.0, kd_tex=tex)
    g = 6.0
    gv = np.array([[-g, -1.7, g], [g, -1.7, g], [-g, -1.7, -g],
                   [g, -1.7, g], [g, -1.7, -g], [-g, -1.7, -g]], np.float32)
    guv = np.array([[0, 0], [4, 0], [0, 4], [4, 0], [4, 4], [0, 4]],
                   np.float32)
    b.add_mesh(gv, np.arange(6).reshape(2, 3), floor_mat, uvs=guv)
    hdr_path = "/root/reference/Resources/MonValley1000.hdr"
    assert os.path.exists(hdr_path)
    img = load_image(hdr_path)
    img = img * np.sqrt(img)  # reference's load-time radiance warp
    l2w = _rot_x(20) @ _rot_y(-90) @ _rot_x(-90)
    b.set_environment(img, light_to_world=l2w)
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.8, 5.0),
                                  look=(0.0, -0.3, 0.0))
    return scene, cam, (v, t)


def _rot_x(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def volumetric_cornell(width=128, height=128, use_reference_volume=True):
    """BASELINE config 5: GridDensityMedium (density_render.70.volume) in a
    null-boundary box inside the Cornell scene + a homogeneous-interior
    glass sphere (RenderThread.cpp:107 parameters sigma_a 2.4? — the
    reference builds HomogeneousMedium(2.4, 1.4, 0.5))."""
    import os

    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])

    # grid medium from the reference resource (loaded via our loader since
    # the reference has none, SURVEY.md §2.5)
    vol_path = "/root/reference/Resources/density_render.70.volume"
    if use_reference_volume and os.path.exists(vol_path):
        from .loaders import load_volume

        vol = load_volume(vol_path)
        density = vol["density"]
        sigma_a, sigma_s = vol["sigma_a"], vol["sigma_s"]
    else:
        z, y, x = np.mgrid[0:32, 0:32, 0:32] / 31.0
        density = np.exp(-8 * ((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2)).astype(np.float32)
        sigma_a, sigma_s = (10.0, 10.0, 10.0), (90.0, 90.0, 90.0)
    # place the unit medium box at [-1,-2.4,-1]x[1,-0.4,1] (on the floor)
    m2w = np.eye(4)
    m2w[0, 0] = 2.0
    m2w[1, 1] = 2.0
    m2w[2, 2] = 2.0
    m2w[:3, 3] = [-1.0, -2.4, -1.0]
    grid_med = b.add_grid_medium(density, np.asarray(sigma_a) * 0.1,
                                 np.asarray(sigma_s) * 0.1, g=0.0,
                                 medium_to_world=m2w)
    # null-material bounding box for the grid (medium interface carrier)
    lo, hi = np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0])
    bv, bt = _box_mesh(lo, hi)
    b.add_mesh(bv, bt, material=-1, medium=(grid_med, -1))

    # homogeneous "glass" sphere: glass surface with interior medium
    hom = b.add_homogeneous_medium((0.24, 0.24, 0.24), (0.14, 0.14, 0.14), g=0.5)
    glass = b.add_glass(eta=1.5)
    b.add_sphere((1.2, -1.5, 0.8), 0.9, glass, medium=(hom, -1))

    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam


def _box_mesh(lo, hi):
    """12-triangle axis-aligned box with outward winding."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    f = np.array([
        [0, 2, 1], [0, 3, 2],  # z0 face (normal -z)
        [4, 5, 6], [4, 6, 7],  # z1 face (+z)
        [0, 1, 5], [0, 5, 4],  # y0 (-y)
        [3, 6, 2], [3, 7, 6],  # y1 (+y)
        [0, 7, 3], [0, 4, 7],  # x0 (-x)
        [1, 2, 6], [1, 6, 5],  # x1 (+x)
    ], np.int32)
    return v, f


def cornell_instanced(width=128, height=128, flatten=False, n_inst=3,
                      bvh=False):
    """Cornell box + n instanced copies of one box mesh (rotated / scaled /
    translated) — the renderable TransformedPrimitive scene the reference
    supports structurally (core/Primitive.cpp:80-101) but never builds.

    flatten=True bakes each instance into the main triangle buffer instead
    (identical geometry through add_mesh pre-transform), so tests can assert
    the instanced render equals the flattened one through the full
    integrator stack.
    """
    b = SceneBuilder()
    mats = reference_materials(b)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    v, f = _box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    xforms = []
    for i in range(n_inst):
        s = 0.8 + 0.3 * i
        m = _rot_y(25.0 * (i + 1)) @ np.diag([s, s * 1.2, s, 1.0])
        m = _translate([-1.5 + 1.5 * i, -2.9 + 0.6 * s, -0.5 + 0.4 * i]) @ m
        xforms.append(m.astype(np.float32))
    if flatten:
        for m in xforms:
            b.add_mesh(v, f, mats["white"], transform=m)
        scene = b.build(bvh=bvh)
    else:
        b.add_instances(v, f, np.stack(xforms), material=mats["white"],
                        bvh=bvh)
        scene = b.build(bvh=bvh)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return scene, cam


def sphere_point_light(width=64, height=64):
    """BASELINE config 1: single matte sphere + PointLight."""
    b = SceneBuilder()
    m = b.add_matte((0.7, 0.5, 0.4), sigma=0.0)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, m)
    b.add_point_light((2.0, 3.0, 4.0), (100.0, 100.0, 100.0))
    scene = b.build()
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0))
    return scene, cam
