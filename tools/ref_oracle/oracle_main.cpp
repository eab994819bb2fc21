// Headless parity oracle for the reference renderer.
//
// Links the reference's render core (/root/reference: core/, shape/,
// accelerator/, materials/, lights/, integrators/, samplers/, camera/)
// unmodified, replacing only the Qt FrameBuffer with a linear stub
// (stub/ui/FrameBuffer.h).  The scenes below are the reference's own
// hardcoded Cornell scene (ui/RenderThread.cpp:46-187 +
// ui/ModelList.cpp:71-147) plus three BASELINE parity scenes built from
// the same reference classes:
//   gmd     — Cornell + Glass/Mirror/Disney boxes (config 3;
//             materials/GlassMaterial.cpp:14, MirrorMaterial.cpp:13,
//             DisneyMaterial.cpp:467-583)
//   envmesh — .3d mesh (shape/plyRead.h) + ImageTexture floor
//             (textures/ImageTexture.h:42-92) + InfiniteAreaLight HDR
//             (lights/InfiniteAreaLight.cpp:12-121)  (config 4)
//   volpath — Cornell + null-material box holding a HomogeneousMedium
//             (media/HomogeneousMedium.cpp:11-43,
//             integrators/VolPathIntegrator.cpp:24-159)  (config 5)
// Output: raw float32 RGB linear radiance + one JSON line of metadata.
//
// Usage:
//   oracle OUT.raw W H SPP INTEGRATOR MAXDEPTH SIGMA STRATEGY SKYBOX
//          [SCENE] [KD] [LE] [MESH3D]
//     INTEGRATOR: path | whitted | direct | volpath
//     SIGMA:      Matte roughness sigma (reference default 60)
//     STRATEGY:   uniform | power | spatial   (path/volpath only)
//     SKYBOX:     0 | 1  include the (broken-load) SkyBoxLight
//     SCENE:      cornell (default) | gmd | envmesh | volpath
//     KD:         scale on the white-wall Kd (gradient parity FD)
//     LE:         area-light radiance (reference value 5.0)
//     MESH3D:     path to a .3d mesh for SCENE=envmesh

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <memory>
#include <string>
#include <vector>

#include "core/GNXRayTracer.h"
#include "core/Geometry.h"
#include "core/Transform.h"
#include "core/Spectrum.h"
#include "core/Scene.h"
#include "core/Primitive.h"
#include "core/Integrator.h"
#include "core/Texture.h"
#include "core/Medium.h"
#include "accelerator/BVHAccel.h"
#include "camera/Perspective.h"
#include "samplers/HaltonSampler.h"
#include "shape/Triangle.h"
#include "shape/plyRead.h"
#include "materials/MatteMaterial.h"
#include "materials/MirrorMaterial.h"
#include "materials/GlassMaterial.h"
#include "materials/DisneyMaterial.h"
#include "materials/MetalMaterial.h"
#include "materials/PlasticMaterial.h"
#include "textures/ConstantTexture.h"
#include "textures/ImageTexture.h"
#include "lights/DiffuseAreaLight.h"
#include "lights/SkyBoxLight.h"
#include "lights/InfiniteAreaLight.h"
#include "media/HomogeneousMedium.h"
#include "media/GridDensityMedium.h"
#include "integrators/PathIntegrator.h"
#include "integrators/WhittedIntegrator.h"
#include "integrators/DirectLightingIntegrator.h"
#include "integrators/VolPathIntegrator.h"
#include "ui/FrameBuffer.h"

using namespace pbr;

// The reference leaks an unconditional debug printf per unoccluded shadow
// ray (core/Integrator.cpp:143) — hot-loop I/O that would both flood
// stdout and distort the timing baseline.  Interpose printf at link time
// (this object resolves before libc) as a no-op; all oracle output goes
// through fprintf(stderr)/fwrite instead.
extern "C" int printf(const char *, ...) { return 0; }

static std::shared_ptr<Texture<Float>> ftex(float v) {
    return std::make_shared<ConstantTexture<Float>>(v);
}

static std::shared_ptr<Texture<Spectrum>> stex(float r, float g, float b) {
    Spectrum c; c[0] = r; c[1] = g; c[2] = b;
    return std::make_shared<ConstantTexture<Spectrum>>(c);
}

static std::shared_ptr<Material> matte(float r, float g, float b, float sigmaV) {
    return std::make_shared<MatteMaterial>(stex(r, g, b), ftex(sigmaV), ftex(0.f));
}

// Cornell walls: ui/ModelList.cpp:71-119 (verbatim coordinates).
static void addCornell(std::vector<std::shared_ptr<Primitive>> &prims,
                       std::shared_ptr<Material> m1,  // red (tris 6,7)
                       std::shared_ptr<Material> m2,  // blue (tris 8,9)
                       std::shared_ptr<Material> m3) {
    const int nTris = 10;
    static int idx[nTris * 3];
    for (int i = 0; i < nTris * 3; i++) idx[i] = i;
    const float L = 5.0f;
    static Point3f P[nTris * 3] = {
        {0, 0, L}, {L, 0, L}, {0, 0, 0},
        {L, 0, L}, {L, 0, 0}, {0, 0, 0},
        {0, L, L}, {0, L, 0}, {L, L, L},
        {L, L, L}, {0, L, 0}, {L, L, 0},
        {0, 0, 0}, {L, 0, 0}, {L, L, 0},
        {0, 0, 0}, {L, L, 0}, {0, L, 0},
        {0, 0, 0}, {0, L, L}, {0, 0, L},
        {0, 0, 0}, {0, L, 0}, {0, L, L},
        {L, 0, 0}, {L, L, L}, {L, 0, L},
        {L, 0, 0}, {L, L, 0}, {L, L, L},
    };
    static Transform o2w = Translate(Vector3f(-0.5f * L, -0.5f * L, -0.5f * L));
    static Transform w2o = Inverse(o2w);
    auto mesh = std::make_shared<TriangleMesh>(o2w, nTris, idx, nTris * 3, P,
                                               nullptr, nullptr, nullptr, nullptr);
    for (int i = 0; i < nTris; ++i) {
        auto tri = std::make_shared<Triangle>(&o2w, &w2o, false, mesh, i);
        auto m = (i == 6 || i == 7) ? m1 : (i == 8 || i == 9) ? m2 : m3;
        prims.push_back(std::make_shared<GeometricPrimitive>(tri, m, nullptr,
                                                             MediumInterface()));
    }
}

// Area light: ui/ModelList.cpp:121-147 (verbatim), radiance parameterized.
static void addAreaLight(std::vector<std::shared_ptr<Primitive>> &prims,
                         std::vector<std::shared_ptr<Light>> &lights,
                         std::shared_ptr<Material> mat, float Le) {
    static int idx[6] = {0, 1, 2, 3, 4, 5};
    static Point3f P[6] = {
        {-1.4f, 0.f, 1.4f}, {-1.4f, 0.f, -1.4f}, {1.4f, 0.f, 1.4f},
        {1.4f, 0.f, 1.4f},  {-1.4f, 0.f, -1.4f}, {1.4f, 0.f, -1.4f}};
    static Transform o2w = Translate(Vector3f(0.f, 2.45f, 0.f));
    static Transform w2o = Inverse(o2w);
    auto mesh = std::make_shared<TriangleMesh>(o2w, 2, idx, 6, P, nullptr,
                                               nullptr, nullptr, nullptr);
    for (int i = 0; i < 2; ++i) {
        auto tri = std::make_shared<Triangle>(&o2w, &w2o, false, mesh, i);
        auto area = std::make_shared<DiffuseAreaLight>(o2w, MediumInterface(),
                                                       Spectrum(Le), 5, tri, false);
        lights.push_back(area);
        prims.push_back(std::make_shared<GeometricPrimitive>(tri, mat, area,
                                                             MediumInterface()));
    }
}

// Axis-aligned box (the exact vertex/winding layout of our
// scene/presets._box_mesh, so both sides shade identical geometry).
static void addBox(std::vector<std::shared_ptr<Primitive>> &prims,
                   Point3f lo, Point3f hi, std::shared_ptr<Material> mat,
                   const MediumInterface &mi = MediumInterface()) {
    float x0 = lo.x, y0 = lo.y, z0 = lo.z, x1 = hi.x, y1 = hi.y, z1 = hi.z;
    Point3f V[8] = {
        {x0, y0, z0}, {x1, y0, z0}, {x1, y1, z0}, {x0, y1, z0},
        {x0, y0, z1}, {x1, y0, z1}, {x1, y1, z1}, {x0, y1, z1},
    };
    static const int F[36] = {
        0, 2, 1, 0, 3, 2,   4, 5, 6, 4, 6, 7,   0, 1, 5, 0, 5, 4,
        3, 6, 2, 3, 7, 6,   0, 7, 3, 0, 4, 7,   1, 2, 6, 1, 6, 5,
    };
    // TriangleMesh copies the index/vertex arrays; per-call storage is fine.
    std::vector<int> idx(F, F + 36);
    Transform *o2w = new Transform;  // identity, leaked (scene-lifetime)
    Transform *w2o = new Transform;
    auto mesh = std::make_shared<TriangleMesh>(*o2w, 12, idx.data(), 8, V,
                                               nullptr, nullptr, nullptr, nullptr);
    for (int i = 0; i < 12; ++i) {
        auto tri = std::make_shared<Triangle>(o2w, w2o, false, mesh, i);
        prims.push_back(std::make_shared<GeometricPrimitive>(tri, mat, nullptr, mi));
    }
}

// Parse the reference's Resources/density_render.70.volume (text header
// "nx N ny N nz N" + p0/p1/sigma_a/sigma_s lines + nx*ny*nz floats in
// pbrt layout d[(z*ny+y)*nx+x]).  The reference SHIPS this asset but has
// no loader (SURVEY.md §2.5) — this defines one so GridDensityMedium
// (media/GridDensityMedium.cpp:31-87) can be parity-tested at all.
// sigma values are scaled by 0.1 (file: 10/90 -> 1/9), matching
// gnxraytracer/scene/presets.cornell_gridvol.
static std::shared_ptr<Medium> loadGridMedium(const std::string &path,
                                              const Transform &m2w) {
    FILE *f = fopen(path.c_str(), "r");
    if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(2); }
    char tag[32];
    int nx = 0, ny = 0, nz = 0;
    if (fscanf(f, " nx %d ny %d nz %d", &nx, &ny, &nz) != 3) {
        fprintf(stderr, "bad .volume header\n"); exit(2);
    }
    float p0[3], p1[3], sa[3], ss[3];
    if (fscanf(f, " %31s %f %f %f", tag, &p0[0], &p0[1], &p0[2]) != 4 ||
        fscanf(f, " %31s %f %f %f", tag, &p1[0], &p1[1], &p1[2]) != 4 ||
        fscanf(f, " %31s %f %f %f", tag, &sa[0], &sa[1], &sa[2]) != 4 ||
        fscanf(f, " %31s %f %f %f", tag, &ss[0], &ss[1], &ss[2]) != 4) {
        fprintf(stderr, "bad .volume header lines\n"); exit(2);
    }
    std::vector<Float> d((size_t)nx * ny * nz, 0.f);
    for (size_t i = 0; i < d.size(); ++i) {
        double v = 0;
        if (fscanf(f, " %lf", &v) != 1) break;
        d[i] = (Float)v;
    }
    fclose(f);
    Spectrum sigA, sigS;
    for (int c = 0; c < 3; ++c) { sigA[c] = sa[c] * 0.1f; sigS[c] = ss[c] * 0.1f; }
    return std::make_shared<GridDensityMedium>(sigA, sigS, 0.f, nx, ny, nz,
                                               m2w, d.data());
}

int main(int argc, char **argv) {
    if (argc < 10) {
        fprintf(stderr, "usage: %s OUT.raw W H SPP path|whitted|direct|volpath "
                        "MAXDEPTH SIGMA STRATEGY SKYBOX [SCENE] [KD] [LE] "
                        "[MESH3D]\n", argv[0]);
        return 2;
    }
    const std::string out = argv[1];
    const int W = atoi(argv[2]), H = atoi(argv[3]), spp = atoi(argv[4]);
    const std::string integ = argv[5];
    const int maxDepth = atoi(argv[6]);
    const float sigma = (float)atof(argv[7]);
    const std::string strategy = argv[8];
    const int skybox = atoi(argv[9]);
    const std::string sceneName = argc > 10 ? argv[10] : "cornell";
    const float kdScale = argc > 11 ? (float)atof(argv[11]) : 1.0f;
    const float Le = argc > 12 ? (float)atof(argv[12]) : 5.0f;
    std::string mesh3d = argc > 13 ? argv[13] : "";
    if (mesh3d == "-") mesh3d = "";
    // Scene-specific FD parameter scale (gradient-parity breadth,
    // VERDICT r3 item 5): gmd -> Disney roughness x PSCALE; volpath ->
    // homogeneous sigma_a/sigma_s x PSCALE; envmesh -> InfiniteAreaLight
    // power x PSCALE.
    const float pscale = argc > 14 ? (float)atof(argv[14]) : 1.0f;

    ClockRandomInit();

    FrameBuffer fb;
    fb.InitBuffer(W, H, 4);

    // Camera: ui/RenderThread.cpp:58-68 (envmesh uses the raised viewpoint
    // of our envmap_mesh preset so the floor + horizon are in frame)
    Vector3f up(0.f, 1.f, 0.f);
    Point3f eye(0.f, 0.f, 5.f), look(0.f, 0.f, 0.f);
    if (sceneName == "envmesh") { eye = Point3f(0.f, 0.8f, 5.f); look = Point3f(0.f, -0.3f, 0.f); }
    Transform lookat = LookAt(eye, look, up);
    Transform c2w0 = Inverse(lookat), c2w1 = c2w0;
    AnimatedTransform animatedTrans(&c2w0, 0.f, &c2w1, 1.f);
    std::shared_ptr<const Camera> camera(
        CreatePerspectiveCamera(W, H, animatedTrans));

    // Materials: ui/RenderThread.cpp:78-103
    auto white = matte(0.91f * kdScale, 0.91f * kdScale, 0.91f * kdScale, sigma);
    auto red = matte(0.9f, 0.1f, 0.17f, sigma);
    auto blue = matte(0.14f, 0.21f, 0.87f, sigma);
    auto dragon = matte(0.2f, 0.8f, 0.2f, sigma);

    std::vector<std::shared_ptr<Primitive>> prims;
    std::vector<std::shared_ptr<Light>> lights;
    std::shared_ptr<Medium> keepMedium;  // scene-lifetime medium

    if (sceneName == "cornell" || sceneName == "gmd" ||
        sceneName == "volpath" || sceneName == "gridvol" ||
        sceneName == "metal") {
        addCornell(prims, red, blue, white);
        addAreaLight(prims, lights, dragon, Le);
    }

    if (sceneName == "metal") {
        // Metal + Plastic boxes: the reference app's OWN presets —
        // getYelloMetalMaterial (ui/MaterialList.cpp:58-69: eta
        // (.2,.2,.8), k (.11,.11,.11), rough .15, remap=false) and
        // getPurplePlasticMaterial (ui/MaterialList.cpp:49-56: kd purple,
        // kr = 1-purple, rough .1, remap=true).  Mirrored in
        // gnxraytracer/scene/presets.cornell_metal.
        auto metal = std::make_shared<MetalMaterial>(
            stex(0.2f, 0.2f, 0.8f), stex(0.11f, 0.11f, 0.11f), ftex(0.15f),
            ftex(0.15f), ftex(0.15f), ftex(0.f), false);
        auto plastic = std::make_shared<PlasticMaterial>(
            stex(0.35f, 0.12f, 0.48f), stex(0.65f, 0.88f, 0.52f),
            ftex(0.1f), ftex(0.f), true);
        addBox(prims, {-1.6f, -2.5f, -0.5f}, {-0.3f, -1.1f, 0.7f}, metal);
        addBox(prims, {0.5f, -2.5f, -0.9f}, {1.8f, -0.9f, 0.4f}, plastic);
    }

    if (sceneName == "gmd") {
        // config 3: Glass / Mirror / Disney boxes (coordinates mirrored in
        // gnxraytracer/scene/presets.cornell_gmd)
        auto glass = std::make_shared<GlassMaterial>(
            stex(1.f, 1.f, 1.f), stex(1.f, 1.f, 1.f), ftex(0.f), ftex(0.f),
            ftex(1.5f), ftex(0.f), true);
        auto mirror = std::make_shared<MirrorMaterial>(
            stex(0.9f, 0.9f, 0.9f), ftex(0.f));
        auto disney = std::make_shared<DisneyMaterial>(
            stex(0.7f, 0.3f, 0.2f), ftex(0.4f), ftex(1.5f),
            ftex(0.3f * pscale),
            ftex(0.f), ftex(0.f), ftex(0.5f), ftex(0.5f), ftex(1.0f),
            ftex(1.0f), ftex(0.f), stex(0.f, 0.f, 0.f), false, ftex(0.f),
            ftex(1.0f), ftex(0.f));
        addBox(prims, {-1.9f, -2.5f, -0.3f}, {-0.7f, -1.3f, 0.9f}, glass);
        addBox(prims, {0.6f, -2.5f, -1.2f}, {2.0f, -0.7f, 0.2f}, mirror);
        addBox(prims, {-0.35f, -2.5f, 1.0f}, {0.75f, -1.4f, 2.1f}, disney);
    } else if (sceneName == "envmesh") {
        // config 4: .3d mesh + ImageTexture floor + InfiniteAreaLight HDR
        if (!mesh3d.empty()) {
            static plyInfo ply(mesh3d);   // static: outlives TriangleMesh views
            static Transform o2w = Translate(Vector3f(0.f, -0.5f, 0.f));
            static Transform w2o = Inverse(o2w);
            auto mesh = std::make_shared<TriangleMesh>(
                o2w, ply.nTriangles, ply.vertexIndices, ply.nVertices,
                ply.vertexArray, nullptr, nullptr, nullptr, nullptr);
            auto blobMat = matte(0.2f, 0.8f, 0.2f, sigma);
            for (int i = 0; i < ply.nTriangles; ++i) {
                auto tri = std::make_shared<Triangle>(&o2w, &w2o, false, mesh, i);
                prims.push_back(std::make_shared<GeometricPrimitive>(
                    tri, blobMat, nullptr, MediumInterface()));
            }
        }
        // textured ground plane (same vertices/uv as envmap_mesh's floor)
        {
            const float g = 6.0f;
            static Point3f P[6] = {
                {-g, -1.7f, g}, {g, -1.7f, g}, {-g, -1.7f, -g},
                {g, -1.7f, g},  {g, -1.7f, -g}, {-g, -1.7f, -g}};
            static Point2f UV[6] = {
                {0, 0}, {4, 0}, {0, 4}, {4, 0}, {4, 4}, {0, 4}};
            static int idx[6] = {0, 1, 2, 3, 4, 5};
            static Transform o2w, w2o;
            auto mesh = std::make_shared<TriangleMesh>(o2w, 2, idx, 6, P,
                                                       nullptr, nullptr, UV, nullptr);
            auto kdTex = std::make_shared<ImageTexture<RGBSpectrum, Spectrum>>(
                std::unique_ptr<TextureMapping2D>(new UVMapping2D(1, 1, 0, 0)),
                "/root/reference/Resources/awesomeface.jpg", false, 8.f,
                ImageWrap::Repeat, 1.f, true);
            auto floorMat = std::make_shared<MatteMaterial>(kdTex, ftex(0.f),
                                                            ftex(0.f));
            for (int i = 0; i < 2; ++i) {
                auto tri = std::make_shared<Triangle>(&o2w, &w2o, false, mesh, i);
                prims.push_back(std::make_shared<GeometricPrimitive>(
                    tri, floorMat, nullptr, MediumInterface()));
            }
        }
        // InfiniteAreaLight exactly as AddInfLight (ui/ModelList.cpp:172-179)
        Transform l2w = RotateX(20) * RotateY(-90) * RotateX(-90);
        lights.push_back(std::make_shared<InfiniteAreaLight>(
            l2w, Spectrum(1.0f * pscale), 10,
            "/root/reference/Resources/MonValley1000.hdr"));
    } else if (sceneName == "volpath") {
        // config 5: null-material box holding a homogeneous medium
        // (mirrored in presets.cornell_homogeneous)
        keepMedium = std::make_shared<HomogeneousMedium>(
            Spectrum(0.25f * pscale), Spectrum(0.45f * pscale), 0.3f);
        addBox(prims, {-1.0f, -2.4f, -1.0f}, {1.0f, -0.4f, 1.0f}, nullptr,
               MediumInterface(keepMedium.get(), nullptr));
    } else if (sceneName == "gridvol") {
        // BASELINE config 5 proper: GridDensityMedium from the shipped
        // density_render.70.volume in a null-material box (delta tracking
        // Sample + ratio-tracking Tr, media/GridDensityMedium.cpp:31-87).
        // mediumToWorld maps the unit grid cube onto the box.
        static Transform m2w = Translate(Vector3f(-1.f, -2.4f, -1.f)) *
                               Scale(2.f, 2.f, 2.f);
        keepMedium = loadGridMedium(
            "/root/reference/Resources/density_render.70.volume", m2w);
        addBox(prims, {-1.0f, -2.4f, -1.0f}, {1.0f, -0.4f, 1.0f}, nullptr,
               MediumInterface(keepMedium.get(), nullptr));
    }

    if (skybox) {
        Transform skyToWorld;
        Point3f center(0.f, 0.f, 0.f);
        lights.push_back(std::make_shared<SkyBoxLight>(skyToWorld, center,
                                                       10.0f, "1", 1));
    }

    Scene scene(std::make_shared<BVHAccel>(prims, 1), lights);

    Bounds2i bounds(Point2i(0, 0), Point2i(W, H));
    auto sampler = std::make_shared<HaltonSampler>(spp, bounds, false);

    std::shared_ptr<Integrator> integrator;
    if (integ == "path")
        integrator = std::make_shared<PathIntegrator>(maxDepth, camera, sampler,
                                                      bounds, &fb, 1.f, strategy);
    else if (integ == "volpath")
        integrator = std::make_shared<VolPathIntegrator>(maxDepth, camera,
                                                         sampler, bounds, 1.f,
                                                         strategy, &fb);
    else if (integ == "whitted")
        integrator = std::make_shared<WhittedIntegrator>(maxDepth, camera,
                                                         sampler, bounds, &fb);
    else
        integrator = std::make_shared<DirectLightingIntegrator>(
            LightStrategy::UniformSampleOne, maxDepth, camera, sampler, bounds, &fb);

    double frameTime = 0.0;
    auto t0 = std::chrono::steady_clock::now();
    integrator->Render(scene, frameTime);
    auto t1 = std::chrono::steady_clock::now();
    double wall = std::chrono::duration<double>(t1 - t0).count();

    fb.dumpLinearRGB(out);
    double paths = (double)W * H * spp;
    fprintf(stderr,
           "{\"w\": %d, \"h\": %d, \"spp\": %d, \"integrator\": \"%s\", "
           "\"max_depth\": %d, \"sigma\": %.1f, \"strategy\": \"%s\", "
           "\"skybox\": %d, \"scene\": \"%s\", \"kd_scale\": %.4f, "
           "\"light_e\": %.4f, \"wall_s\": %.3f, \"frame_time_s\": %.3f, "
           "\"Mpaths_per_s\": %.4f}\n",
           W, H, spp, integ.c_str(), maxDepth, sigma, strategy.c_str(), skybox,
           sceneName.c_str(), kdScale, Le, wall, frameTime, paths / wall / 1e6);
    return 0;
}
